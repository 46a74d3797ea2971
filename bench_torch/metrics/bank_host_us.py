"""The host's part of a ``StreamingEncoderBank`` tick, in us: the program
span ``aad.stream_encode.bank`` less its ``aad.d2h`` (the wait for the
tick's device work and its copy down), the mean over the ticks: the
remainders joined to the tick's samples in the pinned upload, the table of
feeds, the upload's enqueue, the launches of kernels 3 and 4, the split of
the tick's rows into each slot's bytes. None where the program marks no
tick."""

from harness import spans


def read(trace):
    ticks = spans.named(trace, "aad.stream_encode.bank")
    if not ticks:
        return None
    return 1e6 * sum(t.seconds - sum(c.seconds for c in t.within("aad.d2h")) for t in ticks) / len(ticks)
