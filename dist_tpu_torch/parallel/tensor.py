"""The tensor-parallel ``model`` axis (port of
``dist_tpu/parallel/mesh.py::_tp_spec_for``, Megatron's column and row
split).

The JAX package shards the output dim of ``attn/in_proj_weight``,
``mlp/c_fc`` and ``ffn/c_fc`` and the input dim of ``attn/out_proj``,
``mlp/c_proj`` and ``ffn/c_proj`` over the model axis and lets GSPMD put
the all-reduce after the row-split product. The port slices those
weights itself (:func:`shard_model`) and runs each sliced block with
Megatron's pair of functions: :func:`copy_to` (identity forward,
all-reduce of the gradient backward) at the column input and
:func:`reduce_from` (all-reduce forward, identity backward) after the
row output, whose bias is added once, after the reduce. Both sums run in
fp32 and round once to the activations' dtype; each rank's partial
product is rounded before it (one rounding the unsplit product does not
make: at bf16 the split model's scores differ from the unsplit one's by
bf16 noise, ``chip_smoke.py``'s ``PARALLEL_LIMITS``).

The fused projection ``in_proj_weight`` is ``(3D, D)`` with rows
``[q; k; v]``: a contiguous split would give rank 0 all of Q and half of
K. It is split by heads within each of Q, K and V instead, so rank r
holds ``[q_r; k_r; v_r]`` and the attention kernel (K1, and K1b in
training) runs on ``(B, L, 3 D / tp)`` with ``heads / tp`` heads. A
block whose heads (or hidden width) the model axis does not divide stays
replicated. The checkpoints hold the full tensors
(:func:`gather_full`), in the reference's layout. Under ``TPU.FSDP``
FSDP2 shards the slices over the data group and keeps the parameters'
names, which :func:`tp_info`'s specs are keyed by; :func:`gather_full`
and :func:`local_slice` take the slice whole over the data group
(``parallel/shards.py`` gathers a ``DTensor`` first and distributes the
slice last).
"""

import torch
import torch.distributed as dist

from dist_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# module names the rule matches (the JAX package's path suffixes)
ATTENTION = ("attn",)
MLPS = ("mlp", "ffn")


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        # summed in fp32, rounded once
        total = grad.float().contiguous()
        dist.all_reduce(total, group=ctx.group)
        return total.to(grad.dtype), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to(x, group):
    """Identity forward; the gradient all-reduced over ``group`` (in
    fp32)."""
    return _CopyTo.apply(x, group)


def reduce_from(x, group):
    """``x`` summed over ``group``; the gradient passed through."""
    return _ReduceFrom.apply(x, group)


def _qkv_slice(t, size, rank):
    """Rank ``rank``'s heads of each of Q, K and V of a fused ``(3D, ...)``
    tensor, as ``(3 D / size, ...)``."""
    q = t.reshape((3, size, t.shape[0] // (3 * size)) + tuple(t.shape[1:]))
    return q[:, rank].reshape((-1,) + tuple(t.shape[1:]))


def _qkv_naive(t, size, rank):
    n = t.shape[0] // size
    return t[rank * n:(rank + 1) * n]


def _slice(kind, t, size, rank, naive=False):
    if kind == "qkv":
        return (_qkv_naive if naive else _qkv_slice)(t, size, rank)
    dim = 0 if kind == "col" else 1
    if kind == "row" and t.dim() == 1:
        return t                      # a row-split bias stays whole
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n)


def _specs(module, size):
    """{parameter name: kind} of the weights :func:`shard_model` slices,
    kind ``qkv``, ``col`` or ``row``, and the blocks they belong to."""
    from dist_tpu_torch.models.base.blocks import MLP, MultiheadAttention

    specs, blocks = {}, []
    for name, mod in module.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(mod, MultiheadAttention) and leaf in ATTENTION:
            if mod.num_heads % size:
                continue
            specs.update({f"{name}.in_proj_weight": "qkv",
                          f"{name}.in_proj_bias": "qkv",
                          f"{name}.out_proj.weight": "row"})
            blocks.append(mod)
        elif isinstance(mod, MLP) and leaf in MLPS:
            if mod.c_fc.weight.shape[0] % size:
                continue
            specs.update({f"{name}.c_fc.weight": "col",
                          f"{name}.c_fc.bias": "col",
                          f"{name}.c_proj.weight": "row"})
            blocks.append(mod)
    return specs, blocks


def shard_model(module, lay, _naive_qkv=False):
    """Replace the matched weights of ``module`` by this rank's slices over
    the model group of ``lay`` and switch their blocks to the
    tensor-parallel forward. Warns, as the JAX package does, when no
    parameter matched (a non-CLIP backbone: the model axis then buys
    nothing). ``_naive_qkv`` splits ``in_proj`` contiguously: a control
    that must break the agreement. Returns ``module``."""
    size, rank = lay.model, lay.model_rank
    # the blocks' own sentinel is None (no model axis): name the default
    # group when the model axis holds every rank
    group = lay.model_group if lay.model_group is not None \
        else dist.group.WORLD
    specs, blocks = _specs(module, size)
    if not specs:
        logger.warning(
            "TPU.MESH.MODEL=%d but NO parameter matched a tensor-parallel "
            "sharding rule (non-CLIP param naming?) -- all params are "
            "replicated and the model axis buys nothing; set "
            "TPU.MESH.MODEL: 1", size)
    params = dict(module.named_parameters())
    with torch.no_grad():
        for name, kind in specs.items():
            owner, attr = name.rsplit(".", 1)
            sub = module.get_submodule(owner)
            local = _slice(kind, params[name], size, rank,
                           naive=_naive_qkv).clone()
            setattr(sub, attr, torch.nn.Parameter(
                local, requires_grad=params[name].requires_grad))
    for mod in blocks:
        mod.tp_group = group
        if hasattr(mod, "num_heads"):
            mod.num_heads //= size
    module.tp_specs = {"specs": specs, "size": size, "rank": rank,
                       "group": group}
    logger.info("TPU.MESH.MODEL=%d: %d blocks split, %d weights", size,
                len(blocks), len(specs))
    return module


def tp_info(module):
    return getattr(module, "tp_specs", None)


def gather_full(module, name, t):
    """The full tensor of ``t``, this rank's slice of the parameter
    ``name`` of ``module`` (or a tensor laid out as it, an optimizer
    moment), gathered over the model group; ``t`` itself for a weight
    that is not split. Every rank of the group calls in."""
    info = tp_info(module)
    kind = info["specs"].get(name) if info else None
    if kind is None or (kind == "row" and t.dim() == 1):
        return t
    parts = [torch.empty_like(t) for _ in range(info["size"])]
    dist.all_gather(parts, t.contiguous(), group=info["group"])
    if kind == "qkv":
        parts = [p.reshape((3, -1) + tuple(p.shape[1:])) for p in parts]
        return torch.cat(parts, dim=1).reshape(
            (-1,) + tuple(t.shape[1:]))
    return torch.cat(parts, dim=0 if kind == "col" else 1)


def local_slice(module, name, full):
    """This rank's slice of the full tensor ``full`` of parameter ``name``
    (``full`` itself for a weight that is not split)."""
    info = tp_info(module)
    kind = info["specs"].get(name) if info else None
    if kind is None:
        return full
    return _slice(kind, full, info["size"], info["rank"])


def full_shape(module, name, shape):
    """The full shape of parameter ``name`` whose slice has ``shape``."""
    info = tp_info(module)
    kind = info["specs"].get(name) if info else None
    if kind is None or (kind == "row" and len(shape) == 1):
        return tuple(shape)
    dim = 0 if kind in ("qkv", "col") else 1
    shape = list(shape)
    shape[dim] *= info["size"]
    return tuple(shape)
