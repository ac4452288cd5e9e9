"""The reference's arithmetic: every product of two operands (a matrix
product or a convolution) goes through :class:`Precision`, which rounds
both operands before an fp32 product with TF32 off.

- ``float32``: no rounding; the reference itself.
- ``float8``: each operand scaled by its own largest magnitude onto
  float8 e4m3's range (448), rounded to e4m3 and scaled back. That is the
  control of the benchmark's comparisons: the reference computed one
  precision below the bfloat16 the configurations state.

The rounding passes the gradient straight through, so a training step in
``float8`` back-propagates through the rounded operands."""

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


class _StraightThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().float().clamp(min=1e-30)
        scale = E4M3_MAX / amax
        return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale

    @staticmethod
    def backward(ctx, g):
        return g


class Precision:
    """``name``: ``float32`` or ``float8``."""

    def __init__(self, name="float32"):
        if name not in ("float32", "float8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, x):
        if self.name == "float32":
            return x
        return _StraightThrough.apply(x)

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def matmul(self, a, b):
        return self.q(a) @ self.q(b)

    def conv2d(self, x, w, b=None, **kw):
        return F.conv2d(self.q(x), self.q(w), b, **kw)

    def conv3d(self, x, w, b=None, **kw):
        return F.conv3d(self.q(x), self.q(w), b, **kw)


def tf32_off():
    """fp32 products stay fp32 on the card (TF32 would round them)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
