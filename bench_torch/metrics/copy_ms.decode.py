"""Device time of the copies (H2D and D2H) a request, in ms: the
``.to(device)`` and ``.cpu()`` of ``codec/batch.py``."""


def read(trace):
    copies = [o for o in trace.device_ops() if o.kind == "memcpy"]
    if not copies or not trace.requests:
        return None
    return sum(o.seconds for o in copies) * 1e3 / len(trace.requests)
