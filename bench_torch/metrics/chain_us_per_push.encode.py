"""The device time of the encode chain a request of the live encode cell,
in us: kernel 3 (``encode_stream_kernel``, ``encode_stream_paired_kernel``)
on the push's blocks and kernel 4 (``encode_pass_kernel``) rebuilding the
carry, summed over the traced window, over the requests. The latency-bound
work that a push costs the card; None where neither kernel ran."""

KERNELS = ("encode_stream_kernel", "encode_stream_paired_kernel", "encode_pass_kernel")


def read(trace):
    found = trace.kernels(*KERNELS)
    if not found or not trace.requests:
        return None
    return 1e6 * sum(o.seconds for o in found) / len(trace.requests)
