"""The host's wait for a one-launch ``encode_batch`` pile, in ms: the
program's span ``aad.encode_batch.wait`` per request, in the mono 2-bit
cell. There the host queues the pile's upload, kernel 3's launch and the
copy down of its bytes, then waits in this span for kernel 3 and the copy:
kernel 3's time less what the host did while it ran. A program whose
one-launch copy down waits inside ``aad.d2h`` reads about 0 here."""

from harness import spans


def read(trace):
    found = spans.named(trace, "aad.encode_batch.wait")
    if not found:
        return None
    return sum(s.seconds for s in found) / len(trace.requests) * 1e3
