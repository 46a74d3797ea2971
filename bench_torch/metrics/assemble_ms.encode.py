"""The host's assembly of an ``encode_batch`` request's byte strings from
the pile's blocks come down, in ms: the self time of the program's span
``aad.encode_batch.assemble``, per request."""

from harness import spans


def read(trace):
    found = spans.named(trace, "aad.encode_batch.assemble")
    if not found:
        return None
    return sum(s.self_seconds for s in found) / len(trace.requests) * 1e3
