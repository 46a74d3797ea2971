"""Kernel 3's share of its roofline, in %: the least time the traced
requests' encode work could take (``work/k3_encode.py`` at the peaks of
``work/peaks.py``) over the device time kernel 3 took, in the one-card
encode cells."""


def read(trace):
    return trace.roofline("k3_encode")
