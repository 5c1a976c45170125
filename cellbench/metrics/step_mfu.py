"""The whole step's share of the card's peak: the model FLOPs of the
window's steps (``flops/<family>.py``, recomputation not counted) over
the window's seconds and the peak of the precision the configuration
states (``peak``)."""

from cellbench.flops import for_family


def read(r):
    if r.peaks is None or r.window_s <= 0:
        return None
    counts = for_family(r.config["family"])
    total = sum(counts.train_flops_per_step(r.config, r.shapes[i])
                for i in r.window_batches)
    return 100.0 * total / r.window_s / r.peaks[r.config["peak"]]
