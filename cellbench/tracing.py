"""The traced steps of a ``--trace 1`` run: ``torch.profiler`` over a
few steps, reduced in memory (nothing is written) to the device's work
items by class, its busy time (the union of their intervals), and its
idle gaps, each named by the harness's host span it fell in.

The classes are a frozen copy of ``chip_smoke.py``'s ``_kernel_class``.
"""

import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

#: The harness's host spans around its calls into the program.
HOST_SPANS = ("fwd_bwd", "optimizer", "stage_metrics", "drain_metrics")


def kernel_class(name: str) -> str:
    """The part of the step a device work item belongs to, from its name
    (cuDNN's convolution kernels name their pass: fprop, dgrad, wgrad)."""
    n = name.lower()
    if "wgrad" in n:
        return "conv weight gradient"
    if "dgrad" in n:
        return "conv data gradient"
    if "nchwtonhwc" in n or "nhwctonchw" in n:
        return "conv layout transposes"
    if "fft" in n or "cf32" in n:
        return "conv via FFT"
    if "fprop" in n or "convolve" in n or re.search(r"\bconv", n):
        return "conv forward"
    if "flash_" in n:
        return "flash kernels"
    if "gemm" in n or "gemv" in n or "cublas" in n or "cutlass" in n:
        return "dense (cuBLAS)"
    if "max_pool" in n:
        return "max-pool"
    if "memcpy" in n or "memset" in n:
        return "copies and fills"
    return "elementwise and other"


@dataclass
class Trace:
    steps: int
    #: (name, start_ns, end_ns) of every device work item.
    device: List[Tuple[str, int, int]] = field(default_factory=list)
    #: (span name, start_ns, end_ns) of the harness's host spans.
    host: List[Tuple[str, int, int]] = field(default_factory=list)

    def seconds_by_class(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, t0, t1 in self.device:
            c = kernel_class(name)
            out[c] = out.get(c, 0.0) + (t1 - t0) * 1e-9
        return out

    def seconds_where(self, pred) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.device if pred(n)) * 1e-9

    def window(self) -> Tuple[int, int]:
        return (min(t0 for _, t0, _ in self.device),
                max(t1 for _, _, t1 in self.device))

    def busy_and_gaps(self):
        """(busy seconds, window seconds, [(gap seconds, host span)])."""
        spans = sorted((t0, t1) for _, t0, t1 in self.device)
        busy, gaps = 0, []
        cur0, cur1 = spans[0]
        for t0, t1 in spans[1:]:
            if t0 > cur1:
                busy += cur1 - cur0
                gaps.append((cur1, t0))
                cur0, cur1 = t0, t1
            else:
                cur1 = max(cur1, t1)
        busy += cur1 - cur0
        w0, w1 = self.window()
        named = [((g1 - g0) * 1e-9, self.host_span_at(g0)) for g0, g1 in gaps]
        return busy * 1e-9, (w1 - w0) * 1e-9, named

    def host_span_at(self, t: int) -> str:
        inner = [(s1 - s0, n) for n, s0, s1 in self.host if s0 <= t < s1]
        return min(inner)[1] if inner else "between spans"

    def breakdown(self) -> dict:
        ops = sorted(self.seconds_by_class().items(), key=lambda kv: -kv[1])
        _, _, gaps = self.busy_and_gaps()
        gaps.sort(key=lambda g: -g[0])
        return {"device_ops": [[n, s] for n, s in ops[:10]],
                "idle_gaps": [[n, s] for s, n in gaps[:10]]}


def _events(prof):
    """(name, is device work, start_ns, end_ns, is a host span)."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            # Host spans are also drawn on the device's timeline as
            # annotations; they are not work.
            if not e.is_user_annotation():
                yield e.name(), True, t0, t1
        elif e.name() in HOST_SPANS:
            yield e.name(), False, t0, t1


def reduce(prof, steps: int) -> Trace:
    trace = Trace(steps)
    for name, on_device, t0, t1 in _events(prof):
        (trace.device if on_device else trace.host).append((name, t0, t1))
    return trace
