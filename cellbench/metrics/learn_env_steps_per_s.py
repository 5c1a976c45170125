"""Env-steps learned a second: T x B x the steps the window completed,
over the window's seconds (host clock, from the first step's dispatch to
the landing of the last step's metrics)."""


def read(r):
    if r.steps == 0 or r.window_s <= 0:
        return None
    return r.env_steps_per_step * r.steps / r.window_s
