"""The mesh over ``torch.distributed`` (port of
``dist_tpu/parallel/mesh.py``).

The JAX package lays every device of every host out as one mesh (data,
pipe, model) and lets XLA insert the collectives. The port runs one
process per card, each a rank of a ``torch.distributed`` group, and lays
the ranks out as that mesh: rank ``(d * pipe + p) * model + m`` is data
shard ``d``, pipe stage ``p`` and model shard ``m`` (:class:`Layout`),
with one process group per axis. ``TRAIN.BATCH_SIZE`` and
``TEST.BATCH_SIZE`` are per data shard, and the global batch is that
times the data axis.

- **data**: the gradient's global mean, which XLA takes inside the jitted
  step, is ``DistributedDataParallel``'s all-reduce over the data group
  (:func:`wrap_ddp`); under ``TPU.FSDP`` it is FSDP2's reduce-scatter
  over the data group (ZeRO-3: parameters, gradients and optimizer
  moments sharded over the data axis, ``parallel/fsdp.py``), with or
  without a model or pipe axis: FSDP2 then shards what those axes left
  on the rank, as the JAX package's ``shard_params`` adds the data axis
  to a leaf's model or pipe spec.
- **model** (``TPU.MESH.MODEL``): Megatron tensor parallelism of the
  attention and MLP blocks (``parallel/tensor.py``).
- **pipe** (``TPU.MESH.PIPE``): the GPipe schedule of the CLIP tower
  (``parallel/pipeline.py``).

``TPU.MESH.DATA: -1`` means every rank left; an explicit size that does
not tile the ranks raises, as ``build_mesh`` asserts, and so does a pipe
axis together with a model axis (with or without ``TPU.FSDP``). No axis
falls back to a replicated run: a collective the backend refuses raises.
"""

import dataclasses
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from dist_tpu_torch.utils.device import resolve_device
from dist_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _mesh_shape_cfg(cfg):
    """(data, pipe, model) from TPU.MESH; data -1/None = all remaining."""
    model, pipe, data = 1, 1, -1
    if cfg is not None and cfg.get("TPU") and cfg.TPU.get("MESH"):
        model = int(cfg.TPU.MESH.get("MODEL", 1) or 1)
        pipe = int(cfg.TPU.MESH.get("PIPE", 1) or 1)
        data = int(cfg.TPU.MESH.get("DATA", -1) or -1)
    return data, pipe, model


def fsdp_enabled(cfg):
    """``TPU.FSDP``."""
    return bool(cfg is not None and cfg.get("TPU") and cfg.TPU.get("FSDP"))


def data_axis_size(cfg, world):
    """Size of the data axis for a group of ``world`` ranks (the
    global-batch multiplier: global batch = ``TRAIN.BATCH_SIZE`` x this):
    the ranks over pipe x model. Raises where the JAX package's
    ``build_mesh`` refuses the config: a pipe axis with a model axis, pipe
    x model not dividing the ranks, or an explicit ``TPU.MESH.DATA`` that
    does not tile them. ``TPU.FSDP`` composes with either axis."""
    data, pipe, model = _mesh_shape_cfg(cfg)
    if pipe > 1 and model > 1:
        raise ValueError(
            "TPU.MESH: pipe x tensor parallelism is not composed (the "
            "pipeline's stages run whole blocks); pick one of PIPE and MODEL")
    if world % (pipe * model):
        raise ValueError(f"TPU.MESH: {world} ranks not divisible by "
                         f"pipe={pipe} x model={model}")
    if data > 0 and data * pipe * model != world:
        raise ValueError(
            f"TPU.MESH data={data} x pipe={pipe} x model={model} != {world} "
            "ranks; set DATA to -1 to use all ranks")
    return world // (pipe * model)


def requested_world(cfg, device=None):
    """How many ranks a launch without ``torchrun`` starts: data x pipe x
    model for an explicit ``TPU.MESH.DATA``, else every local card when
    ``device`` is the default CUDA card (``None`` or ``"cuda"``), else
    pipe x model (one data shard)."""
    data, pipe, model = _mesh_shape_cfg(cfg)
    if data > 0:
        world = data * pipe * model
    elif device is None or str(device) == "cuda":
        resolve_device(None)          # raises without a card
        world = torch.cuda.device_count()
    else:
        world = pipe * model
    data_axis_size(cfg, world)
    return world


def backend(cfg, device):
    """The process group's backend for ranks on ``device``: ``DIST_BACKEND:
    xla`` (the config tree's default) means NCCL on CUDA and gloo on the
    CPU; an explicit ``gloo`` or ``nccl`` is honoured (gloo's all-reduce
    and broadcast take CUDA tensors, so ranks may share a card)."""
    name = str(cfg.get("DIST_BACKEND") or "xla").lower()
    if name == "xla":
        return "nccl" if device.type == "cuda" else "gloo"
    if name == "nccl" and device.type != "cuda":
        raise ValueError("DIST_BACKEND nccl needs CUDA ranks; the CPU runs "
                         "gloo")
    if name not in ("nccl", "gloo"):
        raise ValueError(f"unknown DIST_BACKEND {name!r}: xla, nccl or gloo")
    return name


@dataclasses.dataclass(frozen=True)
class Layout:
    """This rank's place on the (data, pipe, model) mesh: each axis's
    size, this rank's index on it, the process group of the ranks that
    differ from this one on that axis alone (``None``: the default group,
    when the axis holds every rank) and the pipe group's global ranks,
    in stage order."""

    data: int = 1
    pipe: int = 1
    model: int = 1
    data_rank: int = 0
    pipe_rank: int = 0
    model_rank: int = 0
    data_group: Any = None
    pipe_group: Any = None
    model_group: Any = None
    pipe_ranks: tuple = (0,)


_LAYOUT: Optional[Layout] = None
_LAYOUT_WORLD = None   # the default group the layout was made for


def _axis_groups(sizes, axis, rank):
    """Make every group of ``axis`` (each rank calls for every group, in
    one order, as ``new_group`` requires) and return (this rank's group,
    its global ranks)."""
    data, pipe, model = sizes
    world = data * pipe * model

    def rank_of(d, p, m):
        return (d * pipe + p) * model + m

    others = [(d, p, m) for d in range(data) for p in range(pipe)
              for m in range(model)]
    lines = sorted({tuple(rank_of(*(c[:axis] + (i,) + c[axis + 1:]))
                          for i in range(sizes[axis])) for c in others})
    mine = None, None
    for ranks in lines:
        if len(ranks) == world:
            group = None
        else:
            group = dist.new_group(list(ranks))
        if rank in ranks:
            mine = group, ranks
    return mine


def set_layout(cfg):
    """Lay this group's ranks out as ``cfg``'s mesh (every rank calls in)
    and return the :class:`Layout`."""
    global _LAYOUT, _LAYOUT_WORLD
    world, rank = dist.get_world_size(), dist.get_rank()
    _, pipe, model = _mesh_shape_cfg(cfg)
    data = data_axis_size(cfg, world)
    sizes = (data, pipe, model)
    groups = [_axis_groups(sizes, axis, rank) if sizes[axis] > 1
              else (None, (rank,)) for axis in range(3)]
    layout = Layout(
        data=data, pipe=pipe, model=model,
        data_rank=rank // (pipe * model), pipe_rank=(rank // model) % pipe,
        model_rank=rank % model,
        data_group=groups[0][0], pipe_group=groups[1][0],
        model_group=groups[2][0], pipe_ranks=groups[1][1])
    _LAYOUT, _LAYOUT_WORLD = layout, dist.group.WORLD
    return layout


def layout():
    """This rank's :class:`Layout`: the one :func:`set_layout` made for the
    current group; for a group made otherwise, every rank a data shard;
    outside a group, one rank."""
    if not (dist.is_available() and dist.is_initialized()):
        return Layout()
    if _LAYOUT is not None and _LAYOUT_WORLD is dist.group.WORLD:
        return _LAYOUT
    return Layout(data=dist.get_world_size(), data_rank=dist.get_rank())


def init_distributed(cfg, device=None, rank=None, world_size=None,
                     init_method=None):
    """Join the process group, lay out the mesh (:func:`set_layout`) and
    return this rank's device.

    ``rank`` and ``world_size`` default to ``torchrun``'s ``RANK`` and
    ``WORLD_SIZE``; ``init_method`` to ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``). ``device`` ``None`` binds the card
    ``cuda:LOCAL_RANK``; a given device (``"cpu"``, ``"cuda:0"``) is
    every rank's. A rank that cannot join raises."""
    if rank is None:
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    data_axis_size(cfg, world_size)
    if device is None:
        resolve_device(None)          # raises without a card
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend(cfg, device),
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    set_layout(cfg)
    return device


def prepare_model(model):
    """Lay a freshly built ``model`` (a ``VideoModel``, its full weights
    loaded) out on this rank's mesh before its optimizer is made: the
    model axis's tensor-parallel slices (``parallel/tensor.py``) or the
    pipe axis's stage, this rank's blocks alone (``parallel/pipeline.py``);
    then, under ``TPU.FSDP``, FSDP2's shards over the data axis of what
    the rank holds (``parallel/fsdp.py``): the JAX package's order, the
    data axis added to a leaf's model or pipe spec. Outside a group it
    changes nothing. Returns ``model``."""
    lay = layout()
    if lay.model > 1:
        from dist_tpu_torch.parallel import tensor
        tensor.shard_model(model.module, lay)
    if lay.pipe > 1:
        from dist_tpu_torch.parallel import pipeline
        pipeline.check_model(model, lay)
    if fsdp_enabled(model.cfg) and dist.is_available() and dist.is_initialized():
        from dist_tpu_torch.parallel import fsdp
        fsdp.shard_model(model.module, lay)
    return model


def wrap_ddp(model):
    """Send the train step's forward of ``model`` (a ``VideoModel``)
    through ``DistributedDataParallel`` over the data group, whose
    all-reduce averages the trainable gradients across the data shards in
    the backward (a pipe rank's: its own stage's, with the ranks of that
    stage); returns ``model``. A mesh of one data shard's model or
    pipe ranks has nothing to average, and the module stays as it is; so
    does one under ``TPU.FSDP``, whose FSDP2 reduces the gradients itself
    (:func:`prepare_model`).

    Call it after ``construct_optimizer``, which marks the frozen weights:
    DDP reduces only parameters that require a gradient. One trainable
    module of every DiST ladder never reaches the loss: the last step's
    ``integration2temporal_nets`` (its output would feed a next step), so
    ``find_unused_parameters`` is on, and the train step gives those
    parameters the zero gradient that the JAX package's ``grad`` gives
    them. The EMA copy, the eval step and the checkpoints keep the inner
    module and its keys."""
    lay = layout()
    if fsdp_enabled(model.cfg) or (lay.data == 1 and lay.pipe * lay.model > 1):
        return model
    device = model.device
    model.ddp = torch.nn.parallel.DistributedDataParallel(
        model.module,
        device_ids=[device.index] if device.type == "cuda" else None,
        process_group=lay.data_group, find_unused_parameters=True)
    return model


def finish_gradients(model):
    """After the train step's backward: under FSDP the data mean of the
    gradients FSDP2 does not reduce
    (``parallel/fsdp.py::reduce_replicated_grads``: CLIP's 0-d
    ``logit_scale``, whose gradient every model or pipe rank of a data
    shard computes alike, so it is averaged over the data group alone).
    Otherwise nothing: a pipe stage's gradients stay on its own rank,
    where DDP or FSDP2 has averaged them over the data group."""
    if getattr(model.module, "fsdp_replicated", None):
        from dist_tpu_torch.parallel import fsdp
        fsdp.reduce_replicated_grads(model.module, layout())
