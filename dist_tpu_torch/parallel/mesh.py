"""The data axis over ``torch.distributed`` (port of the data-parallel
part of ``dist_tpu/parallel/mesh.py``).

The JAX package lays every device of every host out as one mesh (data,
pipe, model) and lets XLA insert the collectives. The port runs one
process per card, each a rank of a ``torch.distributed`` group: one rank
is one data shard, ``TRAIN.BATCH_SIZE`` and ``TEST.BATCH_SIZE`` are per
rank, and the global batch is that times the world. The gradient's
global mean, which XLA takes inside the jitted step, is
``DistributedDataParallel``'s all-reduce (:func:`wrap_ddp`).

``TPU.MESH.DATA: -1`` means the world; an explicit size other than the
world raises, as ``build_mesh`` asserts. The ``model`` and ``pipe`` axes
and ``TPU.FSDP``'s sharding are not ported: the first two raise, and
``TPU.FSDP`` replicates the state with one warning, since sharding
changes where the state lives, not what is computed.
"""

import os

import torch
import torch.distributed as dist

from dist_tpu_torch.utils.device import resolve_device
from dist_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_TODO = "is not ported yet (ROADMAP.md queue A, item 2: multi-GPU, {})"
_MODEL_TODO = "TPU.MESH.MODEL > 1 (the tensor-parallel model axis) " + \
    _TODO.format("4: the tensor-parallel model axis")
_PIPE_TODO = "TPU.MESH.PIPE > 1 (the GPipe pipe axis, parallel/pipeline.py) " \
    + _TODO.format("5: parallel/pipeline.py")
FSDP_WARNING = ("TPU.FSDP: the port replicates the weights and the optimizer "
                "state on every rank (DistributedDataParallel); ZeRO-3 "
                "sharding " + _TODO.format("1: TPU.FSDP as ZeRO-3 over NCCL"))


def _mesh_shape_cfg(cfg):
    """(data, pipe, model) from TPU.MESH; data -1/None = all remaining."""
    model, pipe, data = 1, 1, -1
    if cfg is not None and cfg.get("TPU") and cfg.TPU.get("MESH"):
        model = int(cfg.TPU.MESH.get("MODEL", 1) or 1)
        pipe = int(cfg.TPU.MESH.get("PIPE", 1) or 1)
        data = int(cfg.TPU.MESH.get("DATA", -1) or -1)
    return data, pipe, model


def data_axis_size(cfg, world):
    """Size of the data axis for a group of ``world`` ranks (the
    global-batch multiplier: global batch = ``TRAIN.BATCH_SIZE`` x this):
    the world itself. Raises where the JAX package's ``build_mesh``
    refuses the config (an explicit ``TPU.MESH.DATA`` that does not tile
    the devices) and for the axes the port does not have."""
    data, pipe, model = _mesh_shape_cfg(cfg)
    if model > 1:
        raise NotImplementedError(_MODEL_TODO)
    if pipe > 1:
        raise NotImplementedError(_PIPE_TODO)
    if data > 0 and data != world:
        raise ValueError(
            f"TPU.MESH data={data} x pipe={pipe} x model={model} != {world} "
            "ranks; set DATA to -1 to use all ranks")
    return world


def requested_world(cfg, device=None):
    """How many ranks a launch without ``torchrun`` starts: an explicit
    ``TPU.MESH.DATA``, else every local card when ``device`` is the
    default CUDA card (``None`` or ``"cuda"``), else one."""
    data, _, _ = _mesh_shape_cfg(cfg)
    if data > 0:
        world = data
    elif device is None or str(device) == "cuda":
        resolve_device(None)          # raises without a card
        world = torch.cuda.device_count()
    else:
        world = 1
    return data_axis_size(cfg, world)


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


def init_distributed(cfg, device=None, rank=None, world_size=None,
                     init_method=None):
    """Join the process group and return this rank's device.

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
    return device


def wrap_ddp(model):
    """Send the train step's forward of ``model`` (a ``VideoModel``)
    through ``DistributedDataParallel`` over the current group, whose
    all-reduce averages the trainable gradients across ranks in the
    backward; returns ``model``.

    Call it after ``construct_optimizer``, which marks the frozen weights:
    DDP reduces only parameters that require a gradient. One trainable
    module of every DiST ladder never reaches the loss: the last step's
    ``integration2temporal_nets`` (its output would feed a next step), so
    ``find_unused_parameters`` is on, and the train step gives those
    parameters the zero gradient that the JAX package's ``grad`` gives
    them. The EMA copy, the eval step and the checkpoints keep the inner
    module and its keys."""
    if model.cfg is not None and model.cfg.get("TPU") and model.cfg.TPU.get(
            "FSDP"):
        logger.warning(FSDP_WARNING)
    device = model.device
    model.ddp = torch.nn.parallel.DistributedDataParallel(
        model.module,
        device_ids=[device.index] if device.type == "cuda" else None,
        find_unused_parameters=True)
    return model
