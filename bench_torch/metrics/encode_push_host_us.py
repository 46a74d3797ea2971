"""The host's part of a ``StreamingEncoder.push``, in us: the program span
``aad.stream_encode.push`` less its ``aad.d2h`` (the wait for the push's
device work and its copy down), the mean over the pushes: the host buffer,
the upload's enqueue, the padding, mid/side and wrapper ops and the launches
of kernels 3 and 4, the block bytes. None where the program marks no push."""

from harness import spans


def read(trace):
    pushes = spans.named(trace, "aad.stream_encode.push")
    if not pushes:
        return None
    return 1e6 * sum(p.seconds - sum(c.seconds for c in p.within("aad.d2h")) for p in pushes) / len(pushes)
