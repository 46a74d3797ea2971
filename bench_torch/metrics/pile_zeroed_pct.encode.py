"""The share of an ``encode_batch`` pile's upload that the host wrote as
zeros, in %: 100 times the program's counter ``pile_zero_bytes`` over
``h2d_bytes``, over the traced window, where the window holds
``encode_batch`` requests. The host zeroes only the tail of each stream's
last block; a program that zeroes every block past a stream's end as well
counts no such bytes. None where the program keeps no such counter."""

from harness import spans


def read(trace):
    counted = spans.counts() or {}
    zeros, moved = counted.get("pile_zero_bytes"), counted.get("h2d_bytes", 0)
    if zeros is None or moved <= 0 or not spans.named(trace, "aad.encode_batch"):
        return None
    return 100.0 * zeros / moved
