"""The share of an ``encode_batch`` pile's upload that is zeros staged past
the streams' ends, in %: 100 times the program's counter ``pile_pad_bytes``
over ``h2d_bytes``, over the traced window, where the window holds
``encode_batch`` requests; in the mono 2-bit cell. Those blocks encode and
are dropped at assembly. None where the program counts no padding, as a
program without the counter does."""

from harness import spans


def read(trace):
    counted = spans.counts() or {}
    pad, moved = counted.get("pile_pad_bytes"), counted.get("h2d_bytes", 0)
    if pad is None or moved <= 0 or not spans.named(trace, "aad.encode_batch"):
        return None
    return 100.0 * pad / moved
