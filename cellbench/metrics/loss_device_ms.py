"""Device ms a traced step launched from the loss outside the forward
(``stepscope.loss``: V-trace and the loss terms). See
``cellbench/spans.py``."""

from cellbench import spans


def read(r):
    return spans.device_ms(r, "loss")
