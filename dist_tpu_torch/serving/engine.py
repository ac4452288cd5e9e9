"""Inference engine: one config -> one predictor over the local GPUs
(port of ``dist_tpu/serving/engine.py``).

- **Local devices.** One process holds a replica of the model on each
  device of a list, every local card by default
  (``parallel/local.py::Replicas``): a padded bucket that the replicas
  divide is split over them, each launches its own kernels on its own
  card, and the scores are gathered in order, as the JAX engine shards a
  bucket over its data axis when the bucket divides it.

- **Buckets.** A request batch of n clips runs at the smallest bucket of
  1, 2, 4, ..., ``batch_size`` that holds it, padded with zero clips, so
  every request runs at one of a few fixed shapes.
- **uint8 on the wire.** Clips are copied to the card as uint8 and
  normalised there (``tasks/state.py::_prep_video``).
- **Text once.** The label-text features are computed when the engine is
  built and reused by every request.

Checkpoint resolution follows the test task (TEST > last > TRAIN
checkpoint); with none configured the engine serves the model's random
weights, made from ``cfg.RANDOM_SEED`` (load and smoke tests only).
"""

import numpy as np
import torch

from dist_tpu_torch.models.base.models import build_model
from dist_tpu_torch.parallel.local import Replicas, local_devices
from dist_tpu_torch.parallel.mesh import _mesh_shape_cfg
from dist_tpu_torch.tasks.state import (
    compute_text_features,
    load_pretrained,
)
from dist_tpu_torch.utils.checkpoint import load_test_checkpoint
from dist_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# the JAX package's engine refuses a dual head at construction too (an
# assertion, dist_tpu/serving/engine.py); its pointer to the submission
# task does not apply, since that task is not ported
_DUAL_HEAD = ("the serving engine serves single-label heads; a dual "
              "verb/noun head (VIDEO.HEAD.NUM_CLASSES a list) is evaluated "
              "through the eval step and the test task (python -m "
              "dist_tpu_torch.run with TRAIN.ENABLE false), and scored "
              "for a results file by the submission task "
              "(SUBMISSION.ENABLE true: tasks/submission.py)")


_MESH_AXES = ("the serving engine is one process over the local devices, "
              "each a replica of the data axis; TPU.MESH.PIPE and MODEL "
              "split the model over ranks, which python -m "
              "dist_tpu_torch.run starts (set them to 1 to serve)")


class InferenceEngine:
    """Build once, then ``predict(clips) -> scores``.

    clips: uint8 ``(n, T, S, S, 3)`` with ``n <= batch_size``,
    ``T = DATA.NUM_INPUT_FRAMES``, ``S = DATA.TEST_CROP_SIZE``. Returns
    per-clip class scores ``(n, num_classes)`` as numpy (softmax with the
    head's softmax activation). Runs on every local CUDA card unless
    ``device`` names one (``"cpu"`` for the CPU) or ``devices`` lists the
    replicas' devices (``["cuda:0", "cuda:1"]``, ``["cpu", "cpu"]``);
    without a card and without those, raises. One process serves the
    data axis alone: ``TPU.MESH.PIPE`` or ``MODEL`` above 1 raises.
    ``ready`` turns true once :meth:`warmup` or a first request has run
    (the HTTP server's health check reads it).
    """

    def __init__(self, cfg, batch_size=8, device=None, devices=None):
        if isinstance(cfg.VIDEO.HEAD.NUM_CLASSES, (list, tuple)):
            raise NotImplementedError(_DUAL_HEAD)
        _, pipe, model = _mesh_shape_cfg(cfg)
        if pipe > 1 or model > 1:
            raise ValueError(_MESH_AXES)
        self.cfg = cfg
        self.batch_size = int(batch_size)
        self.num_frames = int(cfg.DATA.NUM_INPUT_FRAMES)
        self.crop = int(cfg.DATA.TEST_CROP_SIZE or 224)
        self.num_classes = int(cfg.VIDEO.HEAD.NUM_CLASSES)
        devices = local_devices(device, devices)
        self.model = build_model(cfg, device=devices[0])
        self.device = self.model.device
        load_pretrained(cfg, self.model)
        load_test_checkpoint(cfg, self.model)
        self.replicas = Replicas(self.model, devices)
        self.label_names, self.text_features = self._label_setup()
        self.ready = False

    @property
    def devices(self):
        """The replicas' devices, the first the model's."""
        return self.replicas.devices

    @property
    def text_features(self):
        """The label-text features on the first device, or None. Setting
        them copies them to every replica's device."""
        return self._replica_text[0] if self._replica_text else None

    @text_features.setter
    def text_features(self, text):
        self._replica_text = (None if text is None else
                              [text.to(d) for d in self.replicas.devices])

    def _label_setup(self):
        """Label names and the text features, computed once on the first
        device."""
        from dist_tpu_torch.data.base_dataset import resolve_label_texts

        names, tokens = resolve_label_texts(self.cfg, self.num_classes)
        return names, compute_text_features(self.model, tokens)

    def load_state_dict(self, state_dict):
        """Replace the weights of every replica (names and shapes must
        match exactly) and recompute the label-text features."""
        self.replicas.load_state_dict(state_dict)
        self.label_names, self.text_features = self._label_setup()

    def buckets(self):
        """Batch shapes served: powers of two below ``batch_size``, and
        ``batch_size``."""
        b, bs = 1, []
        while b < self.batch_size:
            bs.append(b)
            b *= 2
        bs.append(self.batch_size)
        return bs

    def warmup(self):
        """Run every bucket once before taking traffic."""
        for b in self.buckets():
            self.predict(np.zeros(
                (b, self.num_frames, self.crop, self.crop, 3), np.uint8))
        logger.info("serving warmup done: buckets=%s frames=%d crop=%d "
                    "classes=%d", self.buckets(), self.num_frames, self.crop,
                    self.num_classes)

    def predict(self, clips):
        """clips uint8 (n <= batch_size, T, S, S, 3) -> scores
        (n, num_classes)."""
        clips = np.asarray(clips)
        expect = (self.num_frames, self.crop, self.crop, 3)
        if clips.ndim != 5 or clips.dtype != np.uint8 \
                or clips.shape[1:] != expect:
            raise ValueError(f"expected uint8 (n, {', '.join(map(str, expect))})"
                             f", got {clips.dtype} {clips.shape}")
        n = clips.shape[0]
        if not 0 < n <= self.batch_size:
            raise ValueError(f"{n} clips for batch size {self.batch_size}")
        bucket = next(b for b in self.buckets() if b >= n)
        if n < bucket:
            clips = np.concatenate(
                [clips, np.zeros((bucket - n,) + expect, np.uint8)])
        preds = self.replicas.run(torch.from_numpy(clips), self._replica_text)
        out = preds[:n].float().cpu().numpy()
        self.ready = True
        return out

    def topk(self, scores, k=5):
        """[(class_index, label_or_None, score), ...] rows per clip."""
        out = []
        for row in np.asarray(scores):
            idx = np.argsort(row)[::-1][:k]
            out.append([(int(i),
                         self.label_names[int(i)] if self.label_names else None,
                         float(row[int(i)])) for i in idx])
        return out
