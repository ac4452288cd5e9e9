"""``TPU.FSDP`` as ZeRO-3 over the data axis (port of
``dist_tpu/parallel/mesh.py::shard_params(fsdp=True)``).

The JAX package shards every leaf of 8192 elements or more over the data
axis on its largest free dim and lets GSPMD all-gather a weight where it
is used and reduce-scatter its gradient. The port does the same with
FSDP2 (``torch.distributed.fsdp.fully_shard``): every parameter becomes
a ``DTensor`` sharded on dim 0 over the data group, so each rank holds
about 1/data of the parameters, and AdamW's moments, made over those
``DTensor`` parameters, are sharded alike. The units, each all-gathered
before its forward and freed after it:

- one per ``ResidualAttentionBlock`` (each CLIP block of both towers,
  frozen or not; the video transformers' blocks too);
- one per DiST ladder step (its TemporalNet, integration network and the
  two fusion modules together);
- the root last (everything else).

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


def units(module):
    """The modules that :func:`shard_model` makes FSDP units of, each a
    module or a list of modules, in the order they are wrapped (the root
    is not among them)."""
    from dist_tpu_torch.models.base.blocks import ResidualAttentionBlock
    from dist_tpu_torch.models.dist.dist_net import DiSTNetwork

    out = [m for m in module.modules() if isinstance(m, ResidualAttentionBlock)]
    for net in module.modules():
        if isinstance(net, DiSTNetwork):
            out.extend([net.temporal_nets[i], net.integration2temporal_nets[i],
                        net.temporal2integration_nets[i],
                        net.integration_nets[i]]
                       for i in range(len(net.temporal_nets)))
    return out


def shard_model(module, lay):
    """Shard ``module``'s parameters over the data group of ``lay`` with
    FSDP2: each of :func:`units`, then the root. Returns ``module``."""
    from torch.distributed.fsdp import fully_shard

    from dist_tpu_torch.models.dist.dist_net import TemporalNet

    device = next(module.parameters()).device
    mesh = _data_mesh(lay, device)
    # FSDP2 shards no 0-d parameter (CLIP's logit_scale): it stays
    # replicated, its gradient averaged by reduce_replicated_grads
    scalars = {p for p in module.parameters() if p.dim() == 0}
    parts = units(module)
    for unit in parts:
        fully_shard(unit, mesh=mesh)
    fully_shard(module, mesh=mesh, ignored_params=scalars or None)
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
