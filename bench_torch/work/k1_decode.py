"""Kernel 1's work (``csrc/decode.cu::aad_decode_lanes``): the bytes and
integer operations that decoding a request's streams needs, from their
shapes alone, whatever kernel does it.

Bytes: every byte of each stream's payload (block headers and data
regions) read once, and every PCM sample a stream holds written once as
int16.

Operations: OPS_PER_SAMPLE a coded sample (a block's four header samples
are copied, not decoded), the instructions no implementation of the
reference's decode step (reference/aad.py, ``Codec.decode``) can go
below on sm_90, each a fused form of the step's arithmetic:
  4  the 4-tap prediction, one IMAD a tap (the rounding constant is the
     first one's addend);
  2  reconstruction: the prediction's shift folded into the add with the
     quantised difference (LEA.HI), then the int16 clamp;
  8  the sign-LMS update, a tap: one IMAD (qdiff * history + 2**14), one
     shift folded into the add to the weight;
  2  the step index: the delta's lookup, then the add under the clamp;
  1  the quantised difference from the step size and the code, by lookup;
  1  the code out of its packed word.
"""

OPS_PER_SAMPLE = 18
KERNELS = ("decode_lanes_kernel",)
TAPS = 4


def coded_samples(n: int, nspb: int) -> int:
    """Decoded (not copied) samples a channel of an n-sample stream."""
    full, rest = divmod(n, nspb)
    return full * (nspb - TAPS) + max(rest - TAPS, 0)


def work(streams: list[dict]) -> tuple[float, float]:
    """(bytes, operations) of decoding ``streams`` (harness/entries.py's work)."""
    num_bytes = sum(s["wire_bytes"] + 2 * s["n"] * s["channels"] for s in streams)
    ops = sum(OPS_PER_SAMPLE * coded_samples(s["n"], s["nspb"]) * s["channels"] for s in streams)
    return num_bytes, ops
