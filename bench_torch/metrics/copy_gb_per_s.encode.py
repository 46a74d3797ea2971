"""The rate of the host <-> card copies, in GB/s: the bytes that the
program's copy spans counted (``h2d_bytes`` + ``d2h_bytes``) over the device
time of the window's ``Memcpy HtoD`` and ``Memcpy DtoH`` operations."""

from harness import spans


def read(trace):
    counted = spans.counts() or {}
    moved = counted.get("h2d_bytes", 0) + counted.get("d2h_bytes", 0)
    seconds = sum(o.seconds for o in trace.device_ops()
                  if o.kind == "memcpy" and ("HtoD" in o.name or "DtoH" in o.name))
    if moved <= 0 or seconds <= 0:
        return None
    return moved / seconds / 1e9
