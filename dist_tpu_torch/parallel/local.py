"""One process over the local devices (port of the JAX package's
single-process mesh over a host's devices, as its serving engine and
``TPU.SHARD_FRAMES`` use it).

The JAX engine holds one program over every local device and shards a
request batch over the data axis when the bucket divides it
(``dist_tpu/serving/engine.py``); ``TPU.SHARD_FRAMES`` spreads one
clip's frames over the devices instead (``dist_tpu/parallel/mesh.py::
frame_sharding``). The port holds a replica of the model on each device
of a list (:class:`Replicas`) and splits the work itself:

- **a batch** (:meth:`Replicas.run`): a padded bucket that the replicas
  divide is split in order, each replica runs its part, and the scores
  are gathered on the first device in order;
- **frames** (:class:`FrameParallelTower`): each replica's frozen CLIP
  tower runs on its share of the kept frames, the taps are gathered on
  the first device along T, and the side network runs there over all
  the dense frames.

The kernels launch through ``ctypes`` on the current device, so each
replica's work runs under its own ``torch.cuda.device``. Two replicas on
one card (``["cuda:0", "cuda:0"]``) prove the split and the gather, not
scaling; on the CPU, ``["cpu", "cpu"]``.
"""

import contextlib
import copy

import torch

from dist_tpu_torch.utils.device import resolve_device
from dist_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def local_devices(device=None, devices=None):
    """The devices of a local run: ``devices`` when given, else every
    local card for the default device (``None`` or ``"cuda"``; raises
    without one), else ``[device]``."""
    if devices:
        return [resolve_device(d) for d in devices]
    if device is None or str(device) == "cuda":
        resolve_device(None)          # raises without a card
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [resolve_device(device)]


def on_device(device):
    """The block's kernels launch on ``device``."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def replicate_model(model, device):
    """A copy of ``model`` (a ``VideoModel``) on ``device``."""
    from dist_tpu_torch.models.base.models import VideoModel

    module = copy.deepcopy(model.module).to(device)
    head = None if model.head is None else copy.deepcopy(model.head).to(device)
    return VideoModel(module=module, head=head, cfg=model.cfg)


class Replicas:
    """``model`` (on ``devices[0]``) and a copy of it on each other device
    of ``devices``, each with its eval step."""

    def __init__(self, model, devices):
        from dist_tpu_torch.tasks.state import make_eval_step

        self.devices = list(devices)
        self.models = [model] + [replicate_model(model, d)
                                 for d in self.devices[1:]]
        self.steps = [make_eval_step(m, model.cfg) for m in self.models]

    def __len__(self):
        return len(self.models)

    def load_state_dict(self, state_dict):
        for m in self.models:
            m.module.load_state_dict(state_dict)

    def run(self, video, text_features=None):
        """Scores of ``video`` (a host or first-device batch): split over
        the replicas when they divide its rows, else on the first one
        alone; gathered on the first device in order. ``text_features``:
        one tensor per replica, or None."""
        k = len(self.models)
        tfs = text_features or [None] * k
        if k == 1 or video.shape[0] % k:
            return self.steps[0]({"video": video.to(self.devices[0]),
                                  "text_features": tfs[0]})["preds"]
        outs = []
        for step, dev, part, tf in zip(self.steps, self.devices,
                                       video.chunk(k), tfs):
            with on_device(dev):
                outs.append(step({"video": part.to(dev, non_blocking=True),
                                  "text_features": tf})["preds"])
        return torch.cat([o.to(self.devices[0]) for o in outs])


class FrameParallelTower:
    """Stands in for a CLIP model's ``visual`` (``tower_runner``): the
    kept frames of a batch split along T over the towers of ``devices``
    (the first the model's own, the others copies), the outputs gathered
    on the first device along T, in the tower's ``(cls_x, x_logits,
    taps)`` layout."""

    def __init__(self, visual, devices):
        self.devices = list(devices)
        self.towers = [visual] + [copy.deepcopy(visual).to(d)
                                  for d in self.devices[1:]]

    def __call__(self, video, collect_taps=True):
        alpha = self.towers[0].sparse_alpha
        kept = video[:, ::alpha] if alpha > 1 else video
        b, t = kept.shape[:2]
        outs = []
        for tower, dev, part in zip(self.towers, self.devices,
                                    torch.tensor_split(kept, len(self.towers),
                                                       dim=1)):
            if part.shape[1] == 0:
                continue
            with on_device(dev):
                outs.append(tower(part.to(dev, non_blocking=True),
                                  collect_taps, sampled=True))
        first = self.devices[0]

        def along_t(xs, lead):
            """Per-device ``lead + (b * t_d, ...)`` -> ``lead + (b * t,
            ...)`` on the first device, frames in order."""
            n = len(lead)
            parts = [x.to(first).reshape(
                tuple(x.shape[:n]) + (b, -1) + tuple(x.shape[n + 1:]))
                for x in xs]
            out = torch.cat(parts, dim=n + 1)
            return out.reshape(tuple(out.shape[:n]) + (b * t,)
                               + tuple(out.shape[n + 2:]))

        cls_x = along_t([o[0] for o in outs], ())
        x_logits = along_t([o[1] for o in outs], ())
        taps = (along_t([o[2] for o in outs], (0,))
                if outs[0][2] is not None else None)
        return cls_x, x_logits, taps


_NOT_SPLIT_LOGGED = set()


def shard_frames(model, devices):
    """Make ``model`` (a ``VideoModel`` on ``devices[0]``) spread its CLIP
    tower's frames over ``devices`` (``TPU.SHARD_FRAMES``). A backbone
    with no CLIP tower computes on the first device, with one log line
    that its frames are not split: the results are the same, only where
    they are computed differs. Returns ``model``."""
    module = model.module
    if not hasattr(module, "tower_runner"):
        name = type(module).__name__
        if name not in _NOT_SPLIT_LOGGED:
            _NOT_SPLIT_LOGGED.add(name)
            logger.info("TPU.SHARD_FRAMES: %s has no CLIP tower; its frames "
                        "are not split and it computes on %s", name,
                        devices[0])
        return model
    if len(devices) > 1:
        module.tower_runner = FrameParallelTower(module.visual, devices)
    logger.info("TPU.SHARD_FRAMES: the CLIP tower's frames over %s",
                [str(d) for d in devices])
    return model


def check_shard_frames(cfg):
    """``TPU.SHARD_FRAMES`` is one process over its local devices: inside
    a group of more than one rank it raises, as the JAX package asserts a
    single process (each rank loads different samples). Returns whether
    it is on."""
    on = bool(cfg.get("TPU") and cfg.TPU.get("SHARD_FRAMES"))
    dist = torch.distributed
    if on and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise ValueError(
            "TPU.SHARD_FRAMES is a single-process path over the local "
            "devices (each rank loads different samples, so a frame split "
            "across ranks would mix distinct videos); use the data axis "
            "across ranks")
    return on
