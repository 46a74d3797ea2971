"""The host's checks and staging of an ``encode_batch`` request, in ms: the
self time of the program's spans ``aad.encode_batch.check`` (shapes, int16
range, file headers) and ``aad.encode_batch.stage`` (the pile laid out in
pinned memory; its ``aad.h2d`` left out), per request."""

from harness import spans


def read(trace):
    found = spans.named(trace, "aad.encode_batch.check", "aad.encode_batch.stage")
    if not found:
        return None
    return sum(s.self_seconds for s in found) / len(trace.requests) * 1e3
