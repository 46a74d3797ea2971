"""The host's queueing of a sharded encode, in ms: the duration of the
program span ``aad.encode_streams_sharded`` (every shard's copy, then every
shard's relayouts and launch; the caller waits for the cards after it), per
request."""

from harness import spans


def read(trace):
    found = spans.named(trace, "aad.encode_streams_sharded")
    if not found:
        return None
    return sum(s.seconds for s in found) / len(trace.requests) * 1e3
