"""Submission task: the multi-view forward over the ``submission`` split
and the results file (port of ``dist_tpu/tasks/submission.py``).

Each video's views are summed into one score vector (a view the loader
repeats to pad the last batch is counted once). A dual verb/noun head
(``BaseHeadx2``) writes the EPIC-KITCHENS test server's JSON: version
0.2, the supervision-level fields, per-class verb and noun scores and the
top-100 actions of the verb x noun outer product, under each video's path
relative to the data root. A single head writes the generic JSON,
version 0.1, each video's class scores under its number. In a
group the model is laid out on the mesh as the test task lays it out
(``parallel/mesh.py::prepare_model``: the model axis's slices, the pipe
axis's stage, ``TPU.FSDP``'s shards); each data shard scores its shard
of the views (its model or pipe ranks the same views together), the
gathers go over the data axis, and rank 0 alone writes the file.
"""

import json
import os

import numpy as np

from dist_tpu_torch.data.builder import build_loader
from dist_tpu_torch.models.base.models import build_model
from dist_tpu_torch.parallel.collectives import all_gather_arrays, is_master_proc
from dist_tpu_torch.parallel.mesh import prepare_model
from dist_tpu_torch.tasks.state import (
    compute_text_features,
    load_pretrained,
    make_eval_step,
    to_device,
)
from dist_tpu_torch.utils import logging
from dist_tpu_torch.utils.checkpoint import load_test_checkpoint
from dist_tpu_torch.utils.device import resolve_device

logger = logging.get_logger(__name__)


def _add_views(metrics, batch, video_preds, seen, num_views, dual):
    """Read one batch's scores back, gather every rank's (the identity in
    one process) and add each view not seen yet to its video's sum."""
    preds = metrics["preds"]
    (ids,) = all_gather_arrays(np.asarray(batch["index"]))
    if dual:
        preds = dict(zip(preds, all_gather_arrays(
            *(v.float().cpu().numpy() for v in preds.values()))))
    else:
        (preds,) = all_gather_arrays(preds.float().cpu().numpy())
    for i, idx in enumerate(ids):
        if int(idx) in seen:
            continue
        seen.add(int(idx))
        v = int(idx) // num_views
        if dual:
            video_preds["verb"][v] += preds["verb_class"][i]
            video_preds["noun"][v] += preds["noun_class"][i]
        else:
            video_preds[v] += preds[i]


def submission_forward(cfg, model, batches, num_videos, num_views,
                       text_features, device):
    """Every view of ``batches`` (host batches of the submission split,
    a loader's) through the eval step: -> the per-video score sums in
    float64, ``(num_videos, C)``, or a dict of the verb and noun sums for
    a dual head. Lag 1: batch k's scores are read back after batch k + 1
    is queued."""
    nc = cfg.VIDEO.HEAD.NUM_CLASSES
    dual = isinstance(nc, (list, tuple))
    if dual:
        video_preds = {"verb": np.zeros((num_videos, int(nc[0]))),
                       "noun": np.zeros((num_videos, int(nc[1])))}
    else:
        video_preds = np.zeros((num_videos, int(nc)))
    eval_step = make_eval_step(model, cfg)
    seen, pending = set(), None
    for batch in batches:
        device_batch = {"video": to_device(batch["video"], device)}
        if text_features is not None:
            device_batch["text_features"] = text_features
        metrics = eval_step(device_batch)
        if pending is not None:
            _add_views(*pending, video_preds, seen, num_views, dual)
        pending = (metrics, batch)
    if pending is not None:
        _add_views(*pending, video_preds, seen, num_views, dual)
    return video_preds


def _video_name(dataset, v, num_views):
    """A collision-free name: the video's path relative to the data root,
    its extension stripped; the video's number where it has no path under
    a root (synthetic clips)."""
    try:
        info = dataset._get_sample_info(v * num_views)
        rel = os.path.relpath(info["path"], dataset.data_root_dir)
    except (KeyError, TypeError, ValueError):
        return str(v)
    return os.path.splitext(rel)[0].replace(os.sep, "/")


def submission_results(cfg, video_preds, name):
    """The results file's dict from the per-video score sums; ``name(v)``
    is video ``v``'s key in the EPIC file."""
    nc = cfg.VIDEO.HEAD.NUM_CLASSES
    if not isinstance(nc, (list, tuple)):
        return {"version": "0.1", "challenge": "action_recognition",
                "results": {str(v): {"scores": video_preds[v].tolist()}
                            for v in range(len(video_preds))}}
    n_verb, n_noun = int(nc[0]), int(nc[1])
    results = {}
    for v in range(len(video_preds["verb"])):
        verb, noun = video_preds["verb"][v], video_preds["noun"][v]
        action = np.outer(verb, noun).ravel()
        k = min(100, action.size)
        top = np.argpartition(-action, k - 1)[:k]
        top = top[np.argsort(-action[top])]
        results[name(v)] = {
            "verb": {str(c): float(verb[c]) for c in range(n_verb)},
            "noun": {str(c): float(noun[c]) for c in range(n_noun)},
            "action": {f"{a // n_noun},{a % n_noun}": float(action[a])
                       for a in top.tolist()},
        }
    return {"version": "0.2", "challenge": "action_recognition",
            "sls_pt": 2, "sls_tl": 3, "sls_td": 3, "results": results}


def submission_test(cfg, device=None):
    """Score every view of the ``submission`` split with the configured
    checkpoint on ``device`` (default: the CUDA card; raises without one
    unless ``device="cpu"``) and write the results file to
    ``OUTPUT_DIR/SUBMISSION.SAVE_RESULTS_PATH`` (rank 0). Returns the
    file's path."""
    device = resolve_device(device)
    np.random.seed(int(cfg.RANDOM_SEED))
    logging.setup_logging(cfg, cfg.TEST.LOG_FILE)

    model = build_model(cfg, device=device)
    load_pretrained(cfg, model)
    load_test_checkpoint(cfg, model)
    prepare_model(model)
    loader = build_loader(cfg, "submission", device=device)
    num_views = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    try:
        dataset = loader.dataset
        text_features = compute_text_features(
            model, getattr(dataset, "text_tokens", None))
        video_preds = submission_forward(
            cfg, model, loader, len(dataset) // num_views, num_views,
            text_features, device)
    finally:
        loader.close()
    results = submission_results(
        cfg, video_preds, lambda v: _video_name(dataset, v, num_views))
    out_path = os.path.join(cfg.OUTPUT_DIR, cfg.SUBMISSION.SAVE_RESULTS_PATH)
    if is_master_proc():
        with open(out_path, "w") as f:
            json.dump(results, f)
        logger.info("Submission written to %s", out_path)
    return out_path
