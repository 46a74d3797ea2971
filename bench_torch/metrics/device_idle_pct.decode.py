"""The share of the traced window in which the card ran no kernel, copy or
fill, in %, in a decode cell."""


def read(trace):
    return trace.idle_pct()
