"""The host's wait in a ``StreamingEncoderBank`` tick, in us: the program
span ``aad.d2h`` inside ``aad.stream_encode.bank`` (the ``.cpu()`` that
waits for the tick's device work, kernels 3 and 4 among it, and copies its
rows down), the mean over the ticks. None where the program marks no
tick."""

from harness import spans


def read(trace):
    ticks = spans.named(trace, "aad.stream_encode.bank")
    if not ticks:
        return None
    return 1e6 * sum(c.seconds for t in ticks for c in t.within("aad.d2h")) / len(ticks)
