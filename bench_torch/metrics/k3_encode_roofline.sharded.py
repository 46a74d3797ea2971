"""Kernel 3's share of its roofline, in %, in the sharded encode cells: the
least time of the traced requests' encode work over kernel 3's device
time on all the cards. A metric apart from ``k3_encode_roofline`` because
it moves the sharded cells' own rate, ``encode_samples_per_s.sharded``."""


def read(trace):
    return trace.roofline("k3_encode")
