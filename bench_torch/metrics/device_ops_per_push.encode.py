"""Device operations (kernels, copies, fills) a request of the live encode
cell: what each ``StreamingEncoder.push`` (and a feed's last push, its
``finish()``) puts on the card: the upload, the padding, mid/side and
wrapper ops, kernels 3 and 4, the block bytes' ops, the copy down."""


def read(trace):
    ops = trace.device_ops()
    if not ops or not trace.requests:
        return None
    return len(ops) / len(trace.requests)
