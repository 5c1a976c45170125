"""Device work items a traced step launched from the optimizer
(``stepscope.optimizer``): the count a foreach optimizer would cut. See
``cellbench/spans.py``."""

from cellbench import spans


def read(r):
    return spans.launches(r, "optimizer")
