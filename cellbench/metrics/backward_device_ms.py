"""Device ms a traced step launched from the backward
(``stepscope.backward``: the gradients, their zero fill and their global
norm). See ``cellbench/spans.py``."""

from cellbench import spans


def read(r):
    return spans.device_ms(r, "backward")
