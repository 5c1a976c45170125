"""The flash kernels' share of their roofline over the traced steps:
the sum of each kernel's bound, max(bytes / HBM bandwidth, FLOPs / f32
peak) from the shapes and the batch's visible pairs
(``flops/flash.py``), over the sum of the flash kernels' device time.
The model attends in f32."""

from cellbench.flops import for_family
from cellbench.flops.flash import bound_seconds


def read(r):
    if r.trace is None or not r.trace.device or r.peaks is None:
        return None
    counts = for_family(r.config["family"])
    if not hasattr(counts, "attention_work_per_step"):
        return None
    measured = r.trace.seconds_where(lambda n: "flash_" in n)
    if measured <= 0:
        return None
    bound = sum(bound_seconds(counts.attention_work_per_step(
        r.config, r.shapes[i]), r.peaks["f32"], r.peaks["hbm_bytes_per_s"])
        for i in r.trace_batches)
    return 100.0 * bound / measured
