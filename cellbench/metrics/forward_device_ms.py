"""Device ms a traced step launched from the model's forward
(``stepscope.forward``, inside the loss). See ``cellbench/spans.py``."""

from cellbench import spans


def read(r):
    return spans.device_ms(r, "forward")
