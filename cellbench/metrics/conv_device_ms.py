"""Device ms a traced step in the convolution classes of the kernel
classification (names starting with "conv")."""

from cellbench.tracing import kernel_class


def read(r):
    if r.trace is None or not r.trace.device:
        return None
    s = r.trace.seconds_where(lambda n: kernel_class(n).startswith("conv"))
    return s * 1e3 / r.trace.steps if s > 0 else None
