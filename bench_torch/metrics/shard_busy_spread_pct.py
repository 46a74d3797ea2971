"""How unevenly the shards' cards worked, in %: the most busy card's time
less the least busy card's, over the most, in the traced window."""


def read(trace):
    if len(trace.devices) < 2:
        return None
    busy = [trace.busy(d) for d in trace.devices]
    if max(busy) <= 0:
        return None
    return 100.0 * (max(busy) - min(busy)) / max(busy)
