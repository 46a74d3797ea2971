"""Kernel 3's work (``csrc/encode.cu::aad_encode_stream``): the bytes and
integer operations that encoding a request's streams needs, from their
shapes alone, whatever kernel does it.

Bytes: every PCM sample read once as int16, every byte of the encoded
payload (block headers and data regions) written once.

Operations: OPS_PER_SAMPLE_PASS a sample a pass of the encode step
(reference/aad.py, ``Codec.encode``), counted as the instructions no
implementation can go below on sm_90, each a fused form of the step:
  4  the 4-tap prediction, one IMAD a tap;
  1  the residual: the prediction's shift folded into the subtraction;
  2  its magnitude and sign;
  3  the code: the magnitude over the step size by a reciprocal (one
     IMAD.HI and one correction), then the clamp to the largest code;
  1  the sign bit into the code;
  1  the quantised difference, by lookup;
  2  the step index: the delta's lookup, then the add under the clamp;
  2  reconstruction: the add, then the int16 clamp;
  8  the sign-LMS update: one IMAD and one shift-add a tap.
Passes a block (the trial search of reference/aad.py, ``encode_blocks``):
one trial encode of the block from the carried state, then for each trial
a re-encode of the previous block (from a stream's second block on) and a
trial encode of the block, then the emitting encode. A trial encode runs
over the block's valid samples past its four head samples; the re-encode
of the previous block over all of its.
"""

OPS_PER_SAMPLE_PASS = 24
KERNELS = ("encode_stream_kernel", "encode_stream_paired_kernel")
TAPS = 4


def sample_passes(n: int, nspb: int, trials: int) -> int:
    """Sample-passes a channel of encoding an n-sample stream."""
    full, rest = divmod(n, nspb)
    blocks = full + (rest > 0)
    coded = full * (nspb - TAPS) + max(rest - TAPS, 0)
    return (2 + trials) * coded + (blocks - 1) * trials * (nspb - TAPS)


def work(streams: list[dict]) -> tuple[float, float]:
    """(bytes, operations) of encoding ``streams`` (harness/entries.py's work)."""
    num_bytes = sum(2 * s["n"] * s["channels"] + s["wire_bytes"] for s in streams)
    ops = sum(OPS_PER_SAMPLE_PASS * sample_passes(s["n"], s["nspb"], s["trials"]) * s["channels"]
              for s in streams)
    return num_bytes, ops
