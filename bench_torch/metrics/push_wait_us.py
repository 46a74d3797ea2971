"""The host's wait at the end of a ``StreamingDecoder.push``, in us: the
program span ``aad.d2h`` inside ``aad.stream_decode.push`` (the ``.cpu()``
that waits for the push's device work and copies its PCM down), the mean
over the pushes."""

from harness import spans


def read(trace):
    pushes = spans.named(trace, "aad.stream_decode.push")
    if not pushes:
        return None
    return 1e6 * sum(c.seconds for p in pushes for c in p.within("aad.d2h")) / len(pushes)
