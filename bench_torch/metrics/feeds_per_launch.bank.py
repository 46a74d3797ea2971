"""Feeds a launch of kernel 3 in the bridge cell: the program's counter
``bank_feeds`` (the slots a ``StreamingEncoderBank`` tick pushed) over the
traced window's launches of kernel 3 (``encode_stream_kernel``,
``encode_stream_paired_kernel``). Near the feeds a tick where a tick is one
launch; 1 where each feed launches its own. None where the window holds no
tick or no launch."""

from harness import spans

KERNELS = ("encode_stream_kernel", "encode_stream_paired_kernel")


def read(trace):
    feeds = (spans.counts() or {}).get("bank_feeds", 0)
    launches = len(trace.kernels(*KERNELS))
    if feeds <= 0 or not launches or not spans.named(trace, "aad.stream_encode.bank"):
        return None
    return feeds / launches
