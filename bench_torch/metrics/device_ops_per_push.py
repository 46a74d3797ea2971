"""Device operations (kernels, copies, fills) a push: the launches that
the host's framing and the decoder's pipeline make for each push of
``StreamingDecoder``."""


def read(trace):
    ops = trace.device_ops()
    if not ops or not trace.requests:
        return None
    return len(ops) / len(trace.requests)
