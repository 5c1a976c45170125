"""The max-pool kernels' share of their roofline over the traced steps,
forward and backward: the bytes they need (``flops/impala.py``) over the
HBM bandwidth, over their device time."""

from cellbench.flops import for_family


def read(r):
    if r.trace is None or not r.trace.device or r.peaks is None:
        return None
    counts = for_family(r.config["family"])
    if not hasattr(counts, "pool_bytes_per_step"):
        return None
    measured = r.trace.seconds_where(lambda n: "max_pool" in n.lower())
    if measured <= 0:
        return None
    need = sum(counts.pool_bytes_per_step(r.config, r.shapes[i])
               for i in r.trace_batches)
    return 100.0 * need / r.peaks["hbm_bytes_per_s"] / measured
