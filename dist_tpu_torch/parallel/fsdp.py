"""``TPU.FSDP`` as ZeRO-3 over the data axis (port of
``dist_tpu/parallel/mesh.py::shard_params(fsdp=True)``).

The JAX package shards every leaf of 8192 elements or more over the data
axis on its largest free dim and lets GSPMD all-gather a weight where it
is used and reduce-scatter its gradient. The port does the same with
FSDP2 (``torch.distributed.fsdp.fully_shard``): every parameter becomes
a ``DTensor`` sharded on dim 0 over the data group (on its largest dim
that the data axis divides where it does not divide dim 0: the text
tower's 77 positions), so each rank holds about 1/data of the
parameters, and AdamW's moments, made over those
``DTensor`` parameters, are sharded alike. With a model axis FSDP2
shards the rank's tensor-parallel slices (``parallel/tensor.py``), with
a pipe axis its stage's blocks (``parallel/pipeline.py``): the JAX
package's data axis added to a leaf's model or pipe spec. The units,
each all-gathered before its forward and freed after it:

- one per ``ResidualAttentionBlock`` (each CLIP block of both towers,
  frozen or not; the video transformers' blocks too), except under a
  pipe axis, where the pipelined tower's stage is one unit (below);
- one per DiST ladder step (its TemporalNet, integration network and the
  two fusion modules together);
- the root last (everything else).

Under a pipe axis the schedule calls each block of the stage at every
one of its ``M + S - 1`` ticks. A unit per block would be all-gathered
and reduce-scattered at every call. The pipelined tower is one unit
instead, kept gathered from its forward to its backward: one all-gather
over the data group at the stage's entry and one reduce-scatter of the
summed gradients after the last tick's backward, as the JAX package's
``shard_map`` takes the stage's weights (``in_specs=P(PIPE)``) gathered
over ``data`` once a step. Like the root's, its weights stay gathered
after a forward without a backward (an eval) until :func:`reshard`.
:func:`count_collectives` counts the all-gathers and reduce-scatters.

Where the port differs from a replicated run, and what it does about it:

- the optimizer, the EMA copy and the loaded checkpoint are made over
  the sharded parameters (``parallel/mesh.py::prepare_model`` runs
  before ``construct_optimizer``);
- the EMA copy is a dict of sharded ``DTensor`` s, and an eval with it
  copies it into the sharded parameters for the call (:func:`swapped`);
- the label texts are encoded through the module's call
  (``VideoModel.encode_text``), whose hooks gather the weights;
- K2's pack cache keys on the weights' address and version, which FSDP2
  reuses when it gathers a unit again into storage it freed, so the
  TemporalNet packs on every call under FSDP
  (``TemporalNet.pack_every_call``);
- the module that never reaches the loss (the last ladder step's
  ``integration2temporal_nets``) gets no gradient from FSDP2's
  reduce-scatter; the train step gives its ``DTensor`` parameters a
  zero one of the same sharding, as under DDP;
- FSDP2 shards no 0-d parameter: CLIP's ``logit_scale`` stays
  replicated, and its gradient is averaged over the data axis after the
  backward (:func:`reduce_replicated_grads`);
- the checkpoints hold full tensors (``parallel/shards.py``).
"""

import contextlib

import torch
import torch.distributed as dist

from dist_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _data_mesh(lay, device):
    from torch.distributed.device_mesh import DeviceMesh

    group = lay.data_group if lay.data_group is not None else dist.group.WORLD
    return DeviceMesh.from_group(group, device.type)


def _pipelined_towers(module):
    """The CLIP towers of ``module`` that a pipe axis runs
    (``parallel/pipeline.py::check_model`` gave them their stage)."""
    from dist_tpu_torch.models.clip.model import Transformer

    return [m for m in module.modules()
            if isinstance(m, Transformer) and m.pipe is not None]


def units(module):
    """The modules that :func:`shard_model` makes FSDP units of, each a
    module or a list of modules, in the order they are wrapped (the root
    is not among them): a pipelined tower's stage whole, before the
    other blocks."""
    from dist_tpu_torch.models.base.blocks import ResidualAttentionBlock
    from dist_tpu_torch.models.dist.dist_net import DiSTNetwork

    towers = _pipelined_towers(module)
    staged = {id(b) for t in towers for b in t.resblocks}
    out = list(towers) + [
        m for m in module.modules()
        if isinstance(m, ResidualAttentionBlock) and id(m) not in staged]
    for net in module.modules():
        if isinstance(net, DiSTNetwork):
            out.extend([net.temporal_nets[i], net.integration2temporal_nets[i],
                        net.temporal2integration_nets[i],
                        net.integration_nets[i]]
                       for i in range(len(net.temporal_nets)))
    return out


def _placement(size):
    """FSDP2's placement of a parameter over ``size`` data ranks: dim 0,
    unless ``size`` does not divide it and divides another dim, then the
    largest such dim (the JAX package's ``_fsdp_axis``), so that each rank
    holds a ``1 / size`` share, as each device does there."""
    from torch.distributed.tensor import Shard

    def place(param):
        dims = [d for d, n in enumerate(param.shape) if n % size == 0]
        if not dims or 0 in dims:
            return Shard(0)
        return Shard(max(dims, key=lambda d: param.shape[d]))

    return place


def shard_model(module, lay):
    """Shard ``module``'s parameters over the data group of ``lay`` with
    FSDP2: each of :func:`units`, then the root. Returns ``module``."""
    from torch.distributed.fsdp import fully_shard

    from dist_tpu_torch.models.dist.dist_net import TemporalNet

    device = next(module.parameters()).device
    mesh = _data_mesh(lay, device)
    placement = _placement(lay.data)
    # FSDP2 shards no 0-d parameter (CLIP's logit_scale): it stays
    # replicated, its gradient averaged by reduce_replicated_grads
    scalars = {p for p in module.parameters() if p.dim() == 0}
    parts = units(module)
    towers = {id(t) for t in _pipelined_towers(module)}
    for unit in parts:
        # a pipelined stage stays gathered across its ticks
        fully_shard(unit, mesh=mesh, shard_placement_fn=placement,
                    reshard_after_forward=id(unit) not in towers)
    fully_shard(module, mesh=mesh, shard_placement_fn=placement,
                ignored_params=scalars or None)
    module.fsdp_replicated = sorted(
        (k for k, p in module.named_parameters() if p in scalars))
    for m in module.modules():
        if isinstance(m, TemporalNet):
            m.pack_every_call = True
    logger.info("TPU.FSDP: %d units and the root sharded over %d data "
                "ranks", len(parts), lay.data)
    return module


def reduce_replicated_grads(module, lay):
    """The data shards' mean gradient of the parameters FSDP2 left
    replicated (after the backward, on every rank)."""
    import torch.distributed as dist

    params = dict(module.named_parameters())
    for name in getattr(module, "fsdp_replicated", ()):
        p = params[name]
        if p.requires_grad:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            dist.all_reduce(p.grad, group=lay.data_group)
            p.grad.div_(lay.data)


def is_fsdp(module):
    from torch.distributed.fsdp import FSDPModule

    return isinstance(module, FSDPModule)


_COLLECTIVES = {"all_gather": ("all_gather_into_tensor", "all_gather_single"),
                "reduce_scatter": ("reduce_scatter_tensor",
                                   "reduce_scatter_single")}


@contextlib.contextmanager
def count_collectives():
    """Count FSDP2's all-gathers and reduce-scatters inside the block:
    yields ``{"all_gather": n, "reduce_scatter": n}``, filled as they are
    issued. FSDP2 issues them through ``torch.distributed``'s flat
    collectives (``all_gather_into_tensor`` and ``reduce_scatter_tensor``,
    ``*_single`` in later releases), which nothing else on the step's path
    calls: the pipe's handoff and the model axis's sums are ``all_gather``
    of a list and ``all_reduce``."""
    counts = {kind: 0 for kind in _COLLECTIVES}
    saved = {}

    def counted(kind, fn):
        def call(*args, **kwargs):
            counts[kind] += 1
            return fn(*args, **kwargs)
        return call

    for kind, names in _COLLECTIVES.items():
        for name in names:
            if hasattr(dist, name):
                saved[name] = getattr(dist, name)
                setattr(dist, name, counted(kind, saved[name]))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def reshard(module):
    """Free every unit's gathered weights, so that the next forward
    gathers the sharded parameters again."""
    from torch.distributed.fsdp import FSDPModule

    for m in module.modules():
        if isinstance(m, FSDPModule):
            m.reshard()


@contextlib.contextmanager
def swapped(module, state_dict):
    """``state_dict`` (an EMA copy: sharded ``DTensor`` s with the
    module's own placements, and full buffers) in ``module``'s sharded
    parameters and buffers inside the block, its own weights restored
    after it; the units are resharded on both sides, so that no gathered
    copy of the other weights is read."""
    reshard(module)
    own = module.state_dict()
    saved = {k: v.detach().clone() for k, v in own.items()
             if k in state_dict and v.is_floating_point()}
    with torch.no_grad():
        for k in saved:
            own[k].copy_(state_dict[k])
    try:
        yield
    finally:
        reshard(module)
        with torch.no_grad():
            for k, v in saved.items():
                own[k].copy_(v)
