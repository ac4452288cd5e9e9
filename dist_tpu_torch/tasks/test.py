"""Multi-view test task (port of ``dist_tpu/tasks/test.py``).

Per clip-view forward -> softmax scores; the TestMeter regroups views by
``dataset index // num_clips`` and sums (or maxes) them per video. In a
data-parallel group each rank scores its own shard of the views and the
ranks gather every rank's scores, labels and ids before the meter, so
every rank finalizes the same accuracies. Under the model or pipe axis
(``parallel/mesh.py``) each data shard's ranks score its views together
and the gathers go over the data axis; under ``TPU.FSDP`` the weights are
sharded over it. Frame-parallel eval (``TPU.SHARD_FRAMES``) is one
process that spreads each clip's kept frames over its local devices
(``parallel/local.py``); the batch is not scaled.
"""

import os
import time

import numpy as np
import torch

from dist_tpu_torch.data.builder import build_loader
from dist_tpu_torch.models.base.models import build_model
from dist_tpu_torch.parallel.collectives import all_gather_arrays, is_master_proc
from dist_tpu_torch.parallel.local import (
    check_shard_frames,
    local_devices,
    shard_frames,
)
from dist_tpu_torch.parallel.mesh import prepare_model
from dist_tpu_torch.tasks.state import (
    compute_text_features,
    load_pretrained,
    make_eval_step,
    to_device,
)
from dist_tpu_torch.utils import logging, misc
from dist_tpu_torch.utils.checkpoint import load_test_checkpoint
from dist_tpu_torch.utils.device import resolve_device
from dist_tpu_torch.utils.meters import EpicKitchenMeter, TestMeter
from dist_tpu_torch.utils.visualization import (
    maybe_dump_first_batch,
    visualization_enabled,
)

logger = logging.get_logger(__name__)

def _check_supported(cfg):
    check_shard_frames(cfg)
    return bool(cfg.get("TPU") and cfg.TPU.get("SHARD_FRAMES"))


def _dump_first_batch(cfg, model, loader):
    """Under ``VISUALIZATION.FEATURE_MAPS`` the feature maps of the
    loader's first batch (``utils/visualization.py``), as the JAX test
    task dumps them before its loop."""
    if not visualization_enabled(cfg):
        return
    text_features = compute_text_features(
        model, getattr(loader.dataset, "text_tokens", None))
    it = iter(loader)
    try:
        first = next(it)
    finally:
        it.close()
    if maybe_dump_first_batch(cfg, model, {"video": first["video"],
                                           "text_features": text_features}):
        logger.info("VISUALIZATION.FEATURE_MAPS written for batch 0")


def test(cfg, device=None, devices=None):
    """Evaluate the configured checkpoint on the test split, every view of
    every video, on ``device`` (default: the CUDA card; raises without one
    unless ``device="cpu"``). Under ``TPU.SHARD_FRAMES`` the CLIP tower's
    frames spread over ``devices`` (default: every local card, or
    ``[device]``; ``["cpu", "cpu"]`` on the CPU), the first of which is
    the model's. Returns the meter: its ``stats`` hold the final top-k
    accuracies, ``video_preds`` the ensembled per-video scores and
    ``timing`` the loop's time."""
    shard = _check_supported(cfg)
    if shard:
        devices = local_devices(device, devices)
        device = devices[0]
    device = resolve_device(device)
    np.random.seed(int(cfg.RANDOM_SEED))
    logging.setup_logging(cfg, cfg.TEST.LOG_FILE)

    model = build_model(cfg, device=device)
    load_pretrained(cfg, model)
    load_test_checkpoint(cfg, model)
    loader = build_loader(cfg, "test", device=device)
    try:
        # the dump runs on the master rank alone, on the whole model: before
        # the mesh lays it out, as in the JAX package
        _dump_first_batch(cfg, model, loader)
        prepare_model(model)
        if shard:
            shard_frames(model, devices)
        if cfg.LOG_MODEL_INFO:
            misc.log_model_info(model.module)
        dataset = loader.dataset
        num_views = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        if len(dataset) % num_views:
            raise ValueError(f"dataset size {len(dataset)} not divisible by "
                             f"views {num_views}")
        num_videos = len(dataset) // num_views
        nc = cfg.VIDEO.HEAD.NUM_CLASSES
        if isinstance(nc, (list, tuple)):
            # EPIC verb/noun joint evaluation
            meter = EpicKitchenMeter(num_videos, num_views, tuple(nc), cfg,
                                     ensemble_method=cfg.DATA.ENSEMBLE_METHOD)
        else:
            meter = TestMeter(num_videos, num_views, int(nc), cfg,
                              ensemble_method=cfg.DATA.ENSEMBLE_METHOD)
        # the label texts are encoded once per run
        text_features = compute_text_features(
            model, getattr(dataset, "text_tokens", None))
        perform_test(cfg, make_eval_step(model, cfg), loader, meter,
                     text_features, device)
    finally:
        loader.close()
    meter.finalize_metrics()
    _save_epic_preds(cfg, meter)
    return meter


def _save_epic_preds(cfg, meter):
    """Persist the ensembled per-video verb/noun scores for
    EPIC-KITCHENS as ``.npz`` beside the log (gated on
    ``DATA.MULTI_LABEL``, the reference's flag for dict-pred datasets)."""
    if "epickitchen" not in str(cfg.TEST.DATASET).lower() or \
            not is_master_proc():
        return
    if not (cfg.DATA.get("MULTI_LABEL") or not cfg.DATA.get("TRAIN_VERSION")):
        return
    if not isinstance(getattr(meter, "video_preds", None), dict):
        return
    stem = os.path.join(cfg.OUTPUT_DIR, cfg.TEST.LOG_FILE.split(".")[0])
    for key, suffix in (("verb_class", "_verb"), ("noun_class", "_noun")):
        np.savez(stem + suffix + ".npz", preds=meter.video_preds[key],
                 labels=meter.video_labels[key])
    logger.info("Saved EPIC verb/noun prediction scores to %s_{verb,noun}.npz",
                stem)


def perform_test(cfg, eval_step, loader, meter, text_features, device):
    """Run ``eval_step`` over ``loader`` into ``meter``.

    Each uint8 batch goes to ``device`` (asynchronously from pinned
    memory) and is normalised there. Lag 1: batch k's predictions are read
    back after batch k + 1 is queued, so the host's bookkeeping overlaps
    the card's forward. Records in ``meter.timing`` the batches, the
    loop's seconds and the seconds spent waiting on the loader."""
    pending = None
    wait_s = 0.0
    batches = 0
    start = time.perf_counter()
    it = iter(loader)
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        wait_s += time.perf_counter() - t0
        if batch is None:
            break
        device_batch = {
            "video": to_device(batch["video"], device),
            "labels": to_device(batch["label"], device, torch.long),
            "mask": to_device(batch["_mask"], device)}
        if text_features is not None:
            device_batch["text_features"] = text_features
        metrics = eval_step(device_batch)
        if pending is not None:
            _consume_test_batch(cfg, meter, *pending)
        pending = (metrics, batch, batches)
        batches += 1
    if pending is not None:
        _consume_test_batch(cfg, meter, *pending)
    meter.timing = {"batches": batches,
                    "loop_s": time.perf_counter() - start,
                    "loader_wait_s": wait_s}
    return meter


def _consume_test_batch(cfg, meter, metrics, batch, cur_iter):
    """Read one batch's predictions back, gather every rank's (the
    identity in one process) and add them to the meter, as
    ``dist_tpu/tasks/test.py::_consume_test_batch`` does."""
    preds = metrics["preds"]
    (ids,) = all_gather_arrays(np.asarray(batch["index"]))
    if isinstance(preds, dict):
        # EPIC dual-head: labels arrive as separate verb/noun columns
        preds = dict(zip(preds, all_gather_arrays(
            *(v.float().cpu().numpy() for v in preds.values()))))
        labels = {"verb_class": batch.get("label_verb", batch["label"]),
                  "noun_class": batch.get("label_noun", batch["label"])}
        labels = dict(zip(labels, all_gather_arrays(
            *(np.asarray(v) for v in labels.values()))))
        meter.update_stats(preds, labels, ids)
        return
    preds, labels = all_gather_arrays(preds.float().cpu().numpy(),
                                      np.asarray(batch["label"]))
    meter.update_stats(preds, labels, ids)
    if (cur_iter + 1) % cfg.LOG_PERIOD == 0:
        logger.info("test iter %d done", cur_iter + 1)
