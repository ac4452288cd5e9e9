"""BatchNorm with the JAX package's semantics (port of
``dist_tpu/models/base/bn.py`` and of the flax ``nn.BatchNorm`` that
every BatchNorm site there uses).

flax's BatchNorm is not ``torch.nn.BatchNorm3d``:

- its running variance takes the *biased* batch variance (torch's takes
  the unbiased one, n / (n - 1) larger);
- its ``momentum`` is the decay of the running stats, torch's
  ``1 - momentum``; :class:`BatchNorm` takes flax's;
- inside the JAX step the batch statistics are those of the global
  batch (XLA all-reduces them under the data sharding). Inside a
  ``torch.distributed`` group of more than one rank, :class:`BatchNorm`
  all-reduces the per-channel sum, sum of squares and count, through the
  differentiable ``torch.distributed.nn.functional.all_reduce``, and
  normalises with them; one process normalises through cuDNN's fused
  BatchNorm (PERF.md: 23 % off TAda2D's step), with the running stats
  updated beside it.

``BN.FREEZE`` puts only the BatchNorm modules on their running stats
while the rest of the network trains (dropout keeps firing):
:func:`set_train_mode` is that rule, the JAX package's ``bn_running``.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from dist_tpu_torch.models.precision import fp32_island


def _world_size():
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _global_batch_stats(x, dims):
    """(mean, biased variance) per channel of every rank's batch: the
    per-channel sums of x and x^2 and the count are all-reduced,
    differentiably, and the variance is E[x^2] - E[x]^2, as XLA's psum
    gives the JAX step."""
    from torch.distributed.nn.functional import all_reduce

    var, mean = torch.var_mean(x, dim=dims, correction=0)
    c = x.shape[1]
    n = x.numel() / c
    count = torch.full((1,), n, dtype=x.dtype, device=x.device)
    sums = all_reduce(torch.cat([mean * n, (var + mean * mean) * n, count]))
    mean = sums[:c] / sums[-1]
    return mean, (sums[c:2 * c] / sums[-1] - mean * mean).clamp_min(0.0)


class BatchNorm(nn.BatchNorm3d):
    """flax's BatchNorm over the channel axis 1 of ``(B, C, ...)``, an
    fp32 island: the input is normalised in fp32 and returned in its
    dtype. ``momentum`` is flax's (0.9: the running stats keep 0.9 of
    themselves a step); ``zero_init`` starts the scale at 0. On ``(N,
    C)`` features it is flax's ``nn.BatchNorm`` over the batch (the
    contrastive heads' projections: ``momentum=0.99, eps=1e-3``)."""

    def __init__(self, num_features, momentum=0.9, eps=1e-5,
                 zero_init=False):
        super().__init__(num_features, eps=eps, momentum=1.0 - momentum)
        self.zero_init = zero_init

    def init_own(self, generator):
        self.reset_running_stats()
        self.weight.fill_(0.0 if self.zero_init else 1.0)
        self.bias.zero_()

    def forward(self, x):
        return fp32_island(self._normalise, x)

    def _normalise(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dims = [0] + list(range(2, x.dim()))
        if _world_size() == 1:
            # cuDNN's fused BatchNorm normalises; torch's running update
            # (unbiased variance) is left out and done here
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=dims, correction=0)
            y = F.batch_norm(x, None, None, self.weight, self.bias, True,
                             0.0, self.eps)
        else:
            mean, var = _global_batch_stats(x, dims)
            # y = x * scale + shift, one pass over x
            scale = self.weight * torch.rsqrt(var + self.eps)
            shift = self.bias - mean * scale
            shape = (1, -1) + (1,) * (x.dim() - 2)
            y = torch.addcmul(shift.view(shape), x, scale.view(shape))
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
            self.num_batches_tracked.add_(1)
        return y


def set_train_mode(module, train, bn_frozen=False):
    """``module`` in train or eval mode; with ``bn_frozen`` (``BN.FREEZE``)
    a training module keeps its BatchNorm modules in eval mode, on their
    running stats, as the JAX package's ``bn_running`` does. The walk
    over the modules (~3 ms for the CLIP+DiST model's 487) is skipped when
    the module is in that mode already."""
    mode = (bool(train), bool(train and bn_frozen))
    if getattr(module, "_train_mode", None) == mode and \
            module.training == mode[0]:
        return module
    module.train(mode[0])
    if mode[1]:
        for m in module.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.eval()
    module._train_mode = mode
    return module
