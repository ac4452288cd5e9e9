"""Shared transformer blocks (port of ``dist_tpu/models/base/blocks.py``).

Activations are batch-major ``(batch, tokens, dim)`` as in the JAX
package. Parameters are fp32 with the reference's torch names and
layouts (``in_proj_weight`` (3D, D), ``out_proj``, ``c_fc``/``c_proj``,
LayerNorm ``weight``/``bias``) and are cast to the activation dtype where
they are used, the JAX package's ``param_dtype=fp32, dtype=<compute>``
policy. LayerNorm and softmax run in fp32 whatever the activation dtype.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from dist_tpu_torch.ops.attention import (
    MAX_FUSED_LEN,
    attention_qkv_plain,
    fused_attention_qkv,
)
from dist_tpu_torch.parallel.tensor import copy_to, reduce_from


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


class Linear(nn.Linear):
    """nn.Linear with fp32 parameters cast to the input's dtype at use."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class Conv2d(nn.Conv2d):
    """nn.Conv2d with fp32 parameters cast to the input's dtype at use."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x.dtype))


class Conv3d(nn.Conv3d):
    """nn.Conv3d with fp32 parameters cast to the input's dtype at use."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x.dtype))


class LayerNorm(nn.Module):
    """LayerNorm computed in fp32 whatever the activation dtype; the output
    is cast back to the input's dtype."""

    def __init__(self, dim, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                         self.eps)
        return y.to(x.dtype)


def _row_out(x, linear, group):
    """A row-split ``linear`` of this rank's slice ``x``: the partial
    products summed over the model axis in fp32 and the bias added once,
    then rounded to ``x``'s dtype once, as the unsplit product's epilogue
    rounds it."""
    y = F.linear(x, linear.weight.to(x.dtype)).float()
    return (reduce_from(y, group) + linear.bias.float()).to(x.dtype)


class MultiheadAttention(nn.Module):
    """Multi-head attention with the fused qkv projection of torch's
    ``nn.MultiheadAttention`` (``in_proj_weight`` (3D, D), ``out_proj``).

    Self-attention hands the fused (B, L, 3D) projection to the attention
    kernel (``ops/attention.py``), as the JAX package does at
    ``blocks.py:91-96``; above ``MAX_FUSED_LEN`` tokens it runs the plain
    version, as the JAX package runs its reference there. Cross-attention
    (``key_value`` given) is plain math mirroring ``blocks.py:97-128``.
    Sliced to its heads by ``parallel/tensor.py``, it runs Megatron's
    tensor-parallel forward over ``tp_group``.
    """

    def __init__(self, dim, num_heads, causal=False):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.causal = causal
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Linear(dim, dim)
        # the model axis's group once parallel/tensor.py has sliced this
        # block to its heads: the tensor-parallel forward
        self.tp_group = None

    def _out(self, out):
        if self.tp_group is None:
            return self.out_proj(out)
        return _row_out(out, self.out_proj, self.tp_group)

    def forward(self, query, key_value=None):
        dtype = query.dtype
        if self.tp_group is not None:
            query = copy_to(query, self.tp_group)
            if key_value is not None:
                key_value = copy_to(key_value, self.tp_group)
        w_in = self.in_proj_weight.to(dtype)
        b_in = self.in_proj_bias.to(dtype)
        if key_value is None:
            qkv = F.linear(query, w_in, b_in)
            if qkv.shape[1] > MAX_FUSED_LEN:
                out = attention_qkv_plain(qkv, self.num_heads, self.causal)
            else:
                out = fused_attention_qkv(qkv, self.num_heads, self.causal)
            return self._out(out)
        wq, wk, wv = w_in.chunk(3, dim=0)
        bq, bk, bv = b_in.chunk(3, dim=0)
        q = F.linear(query, wq, bq)
        k = F.linear(key_value, wk, bk)
        v = F.linear(key_value, wv, bv)
        b, l, dim = q.shape
        m = k.shape[1]
        hd = dim // self.num_heads
        q = q.reshape(b, l, self.num_heads, hd)
        k = k.reshape(b, m, self.num_heads, hd)
        v = v.reshape(b, m, self.num_heads, hd)
        logits = torch.einsum("blhd,bmhd->bhlm", (q * hd ** -0.5).float(),
                              k.float())
        if self.causal:
            logits = logits + torch.full((l, m), float("-inf"),
                                         device=q.device).triu(1)
        weights = torch.softmax(logits, dim=-1).to(dtype)
        out = torch.einsum("bhlm,bmhd->blhd", weights, v).reshape(b, l, dim)
        return self._out(out)


class MLP(nn.Module):
    """CLIP-style MLP: c_fc -> QuickGELU -> c_proj."""

    def __init__(self, dim, hidden_dim, out_dim):
        super().__init__()
        self.c_fc = Linear(dim, hidden_dim)
        self.c_proj = Linear(hidden_dim, out_dim)
        self.tp_group = None          # as MultiheadAttention's

    def forward(self, x):
        if self.tp_group is None:
            return self.c_proj(quick_gelu(self.c_fc(x)))
        h = quick_gelu(self.c_fc(copy_to(x, self.tp_group)))
        return _row_out(h, self.c_proj, self.tp_group)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block; ``causal`` masks the text tower."""

    def __init__(self, dim, num_heads, causal=False):
        super().__init__()
        self.ln_1 = LayerNorm(dim)
        self.attn = MultiheadAttention(dim, num_heads, causal=causal)
        self.ln_2 = LayerNorm(dim)
        self.mlp = MLP(dim, 4 * dim, dim)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class CrossAttentionBlock(nn.Module):
    """Cross-attention with one pre-LN shared by query and key/value."""

    def __init__(self, dim, num_heads):
        super().__init__()
        self.ln_1 = LayerNorm(dim)
        self.attn = MultiheadAttention(dim, num_heads)

    def forward(self, query, key_value):
        return self.attn(self.ln_1(query), key_value=self.ln_1(key_value))


def init_weights(root, generator):
    """Random weights drawn from ``generator`` (a CPU ``torch.Generator``),
    after the JAX package's initialisers: LeCun-normal linear and conv
    kernels, zero biases, unit LayerNorm scales. Modules with parameters
    of their own implement ``init_own(generator)``."""
    with torch.no_grad():
        for m in root.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 0.02, generator=generator)
            elif isinstance(m, MultiheadAttention):
                dim = m.in_proj_weight.shape[1]
                m.in_proj_weight.normal_(0.0, dim ** -0.5, generator=generator)
                m.in_proj_bias.zero_()
            if hasattr(m, "init_own"):
                m.init_own(generator)
