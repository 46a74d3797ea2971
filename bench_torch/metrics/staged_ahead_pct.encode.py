"""The share of an ``encode_batch`` pile's chunks that the host laid out
while an earlier chunk was queued on the card, in %: 100 times the
program's counter ``pile_chunks_staged_ahead`` over ``pile_chunks``, over
the traced window, where the window holds ``encode_batch`` requests. A
pile run in n chunks reads (n - 1) / n; one launch reads 0."""

from harness import spans


def read(trace):
    counted = spans.counts() or {}
    chunks = counted.get("pile_chunks", 0)
    if chunks <= 0 or not spans.named(trace, "aad.encode_batch"):
        return None
    return 100.0 * counted.get("pile_chunks_staged_ahead", 0) / chunks
