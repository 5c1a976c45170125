"""The device's idle share over the traced steps: 1 - the union of its
work items' intervals over the span from the first item's start to the
last one's end."""


def read(r):
    if r.trace is None or not r.trace.device:
        return None
    busy, window, _ = r.trace.busy_and_gaps()
    return 100.0 * (1.0 - busy / window) if window > 0 else None
