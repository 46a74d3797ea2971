"""Kernel 3's work in its wire and bank modes (``csrc/encode.cu::
aad_encode_stream_wire``, ``::aad_encode_stream_bank``): the bytes and
integer operations that encoding a request's pushes needs, from their
totals alone, whatever kernel does it. A request's work is a list of
totals (``bench_torch/entries/bridge_encode.py``: one a tick): ``channels``,
``nspb``, ``trials``, ``samples`` (samples a channel encoded), ``coded``
(of them, those past each block's four head samples), ``warm_blocks``
(blocks that have a block before them: every block of a push but a
stream's first, the first block of a carried push too), ``wire_bytes``.

Bytes: every PCM sample read once as int16, every byte of the encoded
payload (block headers and data regions) written once.

Operations: ``k3_encode.py``'s OPS_PER_SAMPLE_PASS a sample a pass, the
same encode step. Passes: a block's trial encode from the carried state,
then for each trial a re-encode of the previous block over its nspb - 4
coded samples (where the block has one; ``k3_encode.py`` counts them
within a stream, and so misses a carried push's first block's) and a trial
encode, then the emitting encode; the trial and emitting encodes over the
block's coded samples.
"""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location("k3_encode", pathlib.Path(__file__).with_name("k3_encode.py"))
k3_encode = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(k3_encode)

OPS_PER_SAMPLE_PASS = k3_encode.OPS_PER_SAMPLE_PASS
KERNELS = k3_encode.KERNELS
TAPS = k3_encode.TAPS


def sample_passes(t: dict) -> int:
    """Sample-passes a channel of one request's totals."""
    return (2 + t["trials"]) * t["coded"] + t["warm_blocks"] * t["trials"] * (t["nspb"] - TAPS)


def work(totals: list[dict]) -> tuple[float, float]:
    """(bytes, operations) of encoding a request's pushes."""
    num_bytes = sum(2 * t["samples"] * t["channels"] + t["wire_bytes"] for t in totals)
    ops = sum(OPS_PER_SAMPLE_PASS * sample_passes(t) * t["channels"] for t in totals)
    return num_bytes, ops
