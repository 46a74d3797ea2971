"""The host's part of a ``StreamingDecoder.push``, in us: the program span
``aad.stream_decode.push`` less its ``aad.d2h`` (the wait for the push's
device work and its copy down), the mean over the pushes: the byte queue,
block rows, the framing and decode ops' and the kernel's launches."""

from harness import spans


def read(trace):
    pushes = spans.named(trace, "aad.stream_decode.push")
    if not pushes:
        return None
    return 1e6 * sum(p.seconds - sum(c.seconds for c in p.within("aad.d2h")) for p in pushes) / len(pushes)
