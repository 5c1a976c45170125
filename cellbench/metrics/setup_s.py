"""Seconds from the start of ``run.py`` to the first timed step: imports,
the card's set-up, weights and batches, the build (or load) of the
kernel libraries, and the check's steps, which warm every shape."""


def read(r):
    return r.setup_s
