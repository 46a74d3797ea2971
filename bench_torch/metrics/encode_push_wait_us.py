"""The host's wait at the end of a ``StreamingEncoder.push``, in us: the
program span ``aad.d2h`` inside ``aad.stream_encode.push`` (the ``.cpu()``
that waits for the push's device work, kernel 3's chain and kernel 4
among it, and copies its bytes down), the mean over the pushes. None where
the program marks no push."""

from harness import spans


def read(trace):
    pushes = spans.named(trace, "aad.stream_encode.push")
    if not pushes:
        return None
    return 1e6 * sum(c.seconds for p in pushes for c in p.within("aad.d2h")) / len(pushes)
