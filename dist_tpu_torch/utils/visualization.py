"""Feature-map visualization (port of ``dist_tpu/utils/visualization.py``;
the reference's ``models/base/base_blocks.py:36-61``).

With ``cfg.VISUALIZATION.ENABLE`` and ``VISUALIZATION.FEATURE_MAPS.ENABLE``
one forward captures every submodule's output
(``VideoModel.forward_with_intermediates``) and each 5-D map is written
as one channel-normalized tile image a sample under
``<FEATURE_MAPS.BASE_OUTPUT_DIR or OUTPUT_DIR>/<VISUALIZATION.NAME or
"features">/im_<i>/<module>_feature.jpg``. The images are rendered on the
maps' device and written by the port's own JPEG writer
(``utils/jpeg.py``, the bytes ``cv2.imwrite`` writes). Used by the test
task (its first batch) and by ``tools/visualize_features.py``.
"""

import os

import numpy as np
import torch

from dist_tpu_torch.utils import jpeg, logging

logger = logging.get_logger(__name__)


def visualization_enabled(cfg):
    v = cfg.get("VISUALIZATION")
    return bool(v and v.ENABLE and v.FEATURE_MAPS.ENABLE)


def feature_map_image(x):
    """(B, T, H, W, C) feature map (a tensor, or an array) -> per-sample
    (C*H, T*W) uint8 image, on the map's device.

    The reference's rendering (base_blocks.py:45-48): values normalized
    across the CHANNEL axis at each (t, h, w) location, then tiled with
    channels down the rows and frames across the columns; the JAX
    package's fp32 operations in numpy, here in torch (the same bytes)."""
    x = torch.as_tensor(x).float()
    xmin = x.amin(dim=-1, keepdim=True)
    xmax = x.amax(dim=-1, keepdim=True)
    x = (x - xmin) / torch.clamp(xmax - xmin, min=1e-8)
    b, t, h, w, c = x.shape
    img = x.permute(0, 4, 2, 1, 3).reshape(b, c * h, t * w)
    return (img * 255.0).to(torch.uint8)


def _iter_feature_maps(tree, path=()):
    """Yield (dotted_path, array) for every 5-D captured intermediate."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _iter_feature_maps(v, path + (str(k),))
        return
    if isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            suffix = () if len(tree) == 1 else (str(i),)
            yield from _iter_feature_maps(v, path + suffix)
        return
    if hasattr(tree, "ndim") and tree.ndim == 5:
        name = ".".join(p for p in path if p != "__call__") or "output"
        yield name, tree


def dump_feature_maps(cfg, intermediates, base_index=0):
    """Write the per-module feature images for one batch; returns the
    number of files written. Layout matches the reference
    (base_blocks.py:55-58): ``<out>/<NAME>/im_<sample>/<module>_feature.jpg``."""
    out_root = os.path.join(
        cfg.VISUALIZATION.FEATURE_MAPS.BASE_OUTPUT_DIR or cfg.OUTPUT_DIR,
        cfg.VISUALIZATION.NAME or "features")
    written = 0
    for name, arr in _iter_feature_maps(intermediates):
        files = jpeg.encode(feature_map_image(arr))
        for i, data in enumerate(files):
            d = os.path.join(out_root, f"im_{base_index + i}")
            os.makedirs(d, exist_ok=True)
            safe = name.replace("/", "_")
            with open(os.path.join(d, f"{safe}_feature.jpg"), "wb") as f:
                f.write(data)
            written += 1
    logger.info("Wrote %d feature maps under %s", written, out_root)
    return written


def capture_and_dump(cfg, model, batch):
    """Capture the feature maps of one eval forward of ``model`` (a
    ``VideoModel``) on ``batch`` (``{"video", "text_features"}``, a uint8
    video normalized on the model's device) and dump them: (the files
    written, the forward's predictions)."""
    from dist_tpu_torch.tasks.state import _prep_video

    video = batch["video"]
    video = (video if torch.is_tensor(video)
             else torch.from_numpy(np.ascontiguousarray(video)))
    video = _prep_video(cfg, video.to(model.device))
    preds, intermediates = model.forward_with_intermediates(
        video, batch.get("text_features"))
    return dump_feature_maps(cfg, intermediates), preds


def maybe_dump_first_batch(cfg, model, batch):
    """The test-task hook: when cfg.VISUALIZATION.* is on, capture and
    dump the feature maps of one forward on ``batch``
    (:func:`capture_and_dump`). Returns the number of files written.

    The master rank alone writes: every rank holds a different shard of
    the views, and the dump paths (im_<i>/...) are per batch position, so
    ranks writing the same files on a shared OUTPUT_DIR would race and
    mix videos."""
    from dist_tpu_torch.parallel.collectives import is_master_proc

    if not visualization_enabled(cfg) or not is_master_proc():
        return 0
    return capture_and_dump(cfg, model, batch)[0]
