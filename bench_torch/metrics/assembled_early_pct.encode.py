"""The share of an ``encode_batch`` pile's byte strings that the host built
before it waited for the pile's last chunk, in %: 100 times the program's
counter ``pile_streams_assembled_early`` over ``pile_streams``, over the
traced window, where the window holds ``encode_batch`` requests. The
streams that end before the last chunk are built while the card runs the
chunks after theirs; a pile of one launch reads 0."""

from harness import spans


def read(trace):
    counted = spans.counts() or {}
    streams = counted.get("pile_streams", 0)
    if streams <= 0 or not spans.named(trace, "aad.encode_batch"):
        return None
    return 100.0 * counted.get("pile_streams_assembled_early", 0) / streams
