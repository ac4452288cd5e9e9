"""The TAda branch: temporally-adaptive convolutions (port of
``dist_tpu/models/branches/tada.py``).

The reference's ``TAdaConv2d`` builds a weight per (clip, frame),
``W_t = alpha_t * W`` on the input-channel axis, and runs a grouped conv
with ``groups = B * T``. The JAX package uses the identity

    conv(x, W * diag(alpha)) == conv(x * alpha, W)

and so does the port: one elementwise scale of the input, then one
``(1, kh, kw)`` convolution shared by every frame.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from dist_tpu_torch.models.base.blocks import Conv3d
from dist_tpu_torch.models.base.bn import BatchNorm
from dist_tpu_torch.models.base.models import BRANCH_REGISTRY
from dist_tpu_torch.models.precision import island_dtype


class ZeroConv3d(Conv3d):
    """A convolution whose weight starts at zero."""

    def init_own(self, generator):
        self.weight.zero_()
        if self.bias is not None:
            self.bias.zero_()


class RouteFuncMLP(nn.Module):
    """The calibration generator (tada_branch.py:15-63): ``(B, C, T, H,
    W)`` -> ``alpha`` ``(B, C, T, 1, 1)``, in fp32 whatever the activation
    dtype. Frame means plus ``g`` of the clip mean, then the temporal
    convs ``a`` (with BN and ReLU) and ``b`` (zero-init, no bias), plus 1:
    ``alpha`` starts at exactly 1."""

    def __init__(self, c_in, ratio, kernels):
        super().__init__()
        k0, k1 = kernels
        self.g = Conv3d(c_in, c_in, 1)
        self.a = Conv3d(c_in, c_in // ratio, (k0, 1, 1),
                        padding=(k0 // 2, 0, 0))
        self.bn = BatchNorm(c_in // ratio, momentum=0.9)
        self.b = ZeroConv3d(c_in // ratio, c_in, (k1, 1, 1),
                            padding=(k1 // 2, 0, 0), bias=False)

    def forward(self, x):
        frame = x.mean(dim=(3, 4), keepdim=True, dtype=island_dtype(x))
        glob = x.mean(dim=(2, 3, 4), keepdim=True, dtype=island_dtype(x))
        h = F.relu(self.bn(self.a(frame + self.g(glob))))
        return self.b(h) + 1.0


class TAdaConv2d(Conv3d):
    """The temporally-adaptive 2D conv: the input scaled by ``alpha``
    (cast to the input's dtype), then one shared ``(1, kh, kw)`` conv with
    no bias."""

    jax_leaf_prefix = "conv/"
    # the JAX module returns its inner conv's output: captured as both
    jax_output_aliases = ("conv",)

    def __init__(self, c_in, features, kernel, stride=(1, 1)):
        super().__init__(c_in, features, (1,) + tuple(kernel),
                         (1,) + tuple(stride),
                         padding=(0,) + tuple(k // 2 for k in kernel),
                         bias=False)

    def forward(self, x, alpha):
        return super().forward(x * alpha.to(x.dtype))


def avg_pool_same(x, kernel):
    """The stride-1 average pool of ``(B, C, T, H, W)`` over ``kernel``
    with zero padding ``k // 2`` counted in the divisor (flax's and
    torch's default), as a sum of shifted slices in fp32 rounded to
    ``x``'s dtype once. Its backward is deterministic, where torch's CUDA
    ``avg_pool3d`` adds overlapping windows' gradients with atomics."""
    pads = [p for k in reversed(kernel) for p in (k // 2, k // 2)]
    xp = F.pad(x.to(island_dtype(x)), pads)
    size = [n + 2 * (k // 2) - k + 1 for n, k in zip(x.shape[2:], kernel)]
    out = 0
    for dt in range(kernel[0]):
        for dh in range(kernel[1]):
            for dw in range(kernel[2]):
                out = out + xp[:, :, dt:dt + size[0], dh:dh + size[1],
                               dw:dw + size[2]]
    return (out / (kernel[0] * kernel[1] * kernel[2])).to(x.dtype)


@BRANCH_REGISTRY.register()
class TAdaConvBlockAvgPool(nn.Module):
    """The TAda bottleneck with avg-pool aggregation
    (tada_branch.py:147-230): ``a`` 1x1x1, ``b`` the TAdaConv2d calibrated
    by ``b_rf``, ``b_bn(h) + b_avgpool_bn(avg-pool over T of h)`` (the
    pool counts its padding in the divisor; ``b_avgpool_bn`` starts at
    scale 0), ReLU, then ``c`` 1x1x1 and ``c_bn``. Every BN keeps 0.9 of
    its running stats a step."""

    def __init__(self, spec):
        super().__init__()
        branch = spec.get("branch_cfg")
        route_r = branch.get("ROUTE_FUNC_R", 4) if branch else 4
        route_k = tuple(branch.get("ROUTE_FUNC_K", [3, 3])) if branch else (3, 3)
        pool_k = tuple(branch.get("POOL_K", [3, 1, 1])) if branch else (3, 1, 1)
        exp = spec["num_filters"] // spec["expansion_ratio"]
        k, st = spec["kernel_size"], spec["stride"]
        self.pool_k = pool_k
        self.a = Conv3d(spec["dim_in"], exp, 1, bias=False)
        self.a_bn = BatchNorm(exp)
        self.b_rf = RouteFuncMLP(exp, route_r, route_k)
        self.b = TAdaConv2d(exp, exp, (k[1], k[2]), (st[1], st[2]))
        self.b_bn = BatchNorm(exp)
        self.b_avgpool_bn = BatchNorm(exp, zero_init=True)
        self.c = Conv3d(exp, spec["num_filters"], 1, bias=False)
        self.c_bn = BatchNorm(spec["num_filters"])

    def forward(self, x):
        x = F.relu(self.a_bn(self.a(x)))
        h = self.b(x, self.b_rf(x))
        pooled = avg_pool_same(h, self.pool_k)
        x = F.relu(self.b_bn(h) + self.b_avgpool_bn(pooled))
        return self.c_bn(self.c(x))
