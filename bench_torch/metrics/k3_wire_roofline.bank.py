"""Kernel 3's share of its roofline in the bridge cell, in %: the least
time the traced ticks' encode work could take (``work/k3_wire.py``, which
counts a carried feed's re-encode of its previous block, at the peaks of
``work/peaks.py``) over the device time kernel 3 took."""


def read(trace):
    return trace.roofline("k3_wire")
