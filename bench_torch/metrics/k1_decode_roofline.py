"""Kernel 1's share of its roofline, in %: the least time the traced
requests' decode work could take (``work/k1_decode.py`` at the peaks of
``work/peaks.py``) over the device time kernel 1 took."""


def read(trace):
    return trace.roofline("k1_decode")
