"""The 95th percentile over every step of the window of the time between
the event recorded after one step and the one before it."""

from cellbench.loops.learn import p95


def read(r):
    if len(r.step_ms) < 20:
        return None
    return p95(r.step_ms)
