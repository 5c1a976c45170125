"""The arithmetic the reference runs in. ``f32`` is the reference
itself: f32 with TF32 off in cuBLAS and cuDNN. The others are controls,
the reference one step below the precision a configuration states:
``tf32`` (TF32 on in both) below f32, and ``fp8`` below bf16: the trunk
that the configuration computes in bf16 computed in fp8 instead. Each
product of the trunk takes its two operands in float8 e4m3 and gives its
output in e4m3, so the activations between products are fp8; the
gradient that reaches a product's output is rounded to float8 e5m2
before the backward's two products (the fp8 training recipes' formats).
Each rounding to fp8 takes a per-tensor scale (amax over the format's
largest value).
"""

import contextlib

import torch
import torch.nn.functional as F

def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the fp8 ``dtype`` with a per-tensor scale, back
    in ``x``'s dtype."""
    scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Operand(torch.autograd.Function):
    """A product's operand in e4m3; its gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _Output(torch.autograd.Function):
    """A product's output in e4m3; the gradient reaching it in e5m2."""

    @staticmethod
    def forward(ctx, y):
        return _round(y, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


class Precision:
    def __init__(self, name: str):
        if name not in ("f32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def _product(self, fn, x, w):
        if self.name != "fp8":
            return fn(x, w)
        return _Output.apply(fn(_Operand.apply(x), _Operand.apply(w)))

    def conv(self, x, w, b, stride=1, padding=0):
        """A product of the trunk: a convolution, then its bias."""
        y = self._product(lambda x, w: F.conv2d(x, w, stride=stride,
                                                padding=padding), x, w)
        return y + b[:, None, None]

    def linear(self, x, w, b=None):
        """A product of the trunk: a dense layer, then its bias."""
        y = self._product(F.linear, x, w)
        return y if b is None else y + b

    @contextlib.contextmanager
    def flags(self):
        """Hold cuBLAS's and cuDNN's TF32 switches for this precision."""
        cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
        prev = cuda.allow_tf32, cudnn.allow_tf32
        on = self.name == "tf32"
        cuda.allow_tf32, cudnn.allow_tf32 = on, on
        try:
            yield
        finally:
            cuda.allow_tf32, cudnn.allow_tf32 = prev
