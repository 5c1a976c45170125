"""Device ms a traced step launched from the optimizer
(``stepscope.optimizer``, around ``make_apply_step``'s call). See
``cellbench/spans.py``."""

from cellbench import spans


def read(r):
    return spans.device_ms(r, "optimizer")
