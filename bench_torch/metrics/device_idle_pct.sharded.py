"""The share of the traced window in which the cards ran no kernel, copy or
fill, in %, the mean over the cards of a sharded encode cell. A metric
apart from ``device_idle_pct.encode`` because it moves the sharded cells'
own rate, ``encode_samples_per_s.sharded``."""


def read(trace):
    return trace.idle_pct()
