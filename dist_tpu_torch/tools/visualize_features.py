"""Dump per-module feature-map images for videos or for the test set's
first batch (port of ``tools/visualize_features.py``).

The one-command front end for ``cfg.VISUALIZATION.*`` (reference
models/base/base_blocks.py:36-61): one eval forward with every
submodule's output captured, and one channel-normalized tile image a
sample a module under
``FEATURE_MAPS.BASE_OUTPUT_DIR/VISUALIZATION.NAME/im_<i>/`` (JPEGs of the
port's own writer, ``utils/jpeg.py``).

    python -m dist_tpu_torch.tools.visualize_features \\
        --cfg configs/projects/tada/tada2d_k400.yaml \\
        [--videos clip.mp4 ...] [--device cpu] [KEY VALUE ...]

Without ``--videos`` the configured test dataset supplies the first
batch (``DATA.SYNTHETIC true`` works with no data on disk). With
``--videos`` each file gives its centre view, decoded by the native
decoder (``data/native_decoder.py``, which needs FFmpeg's libraries and
raises, saying why, without them). A checkpoint loads by the test-time
priority (TEST.CHECKPOINT_FILE_PATH > last > TRAIN's); a CLIP model gets
label-text features for "a video of class <i>". Runs on the CUDA card;
``--device cpu`` runs on the CPU.
"""

import argparse
import sys

import numpy as np


def load_model(cfg, device=None):
    """(the model with the test task's checkpoint loaded, the label-text
    features of a CLIP model or None) on ``device`` (default: the CUDA
    card)."""
    from dist_tpu_torch.data.tokenizer import tokenize
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.tasks.state import compute_text_features, load_pretrained
    from dist_tpu_torch.utils.checkpoint import load_test_checkpoint

    model = build_model(cfg, device=device)
    load_pretrained(cfg, model)
    load_test_checkpoint(cfg, model)
    text_features = None
    if model.is_text_model:
        n = int(cfg.VIDEO.HEAD.NUM_CLASSES or 10)
        text_features = compute_text_features(
            model, tokenize([f"a video of class {i}" for i in range(n)]))
    return model, text_features


def video_batch(cfg, videos=None, device=None):
    """The uint8 clips ``(N, T, S, S, 3)`` to visualize: each file's
    centre view at the test crop, or the test loader's first batch."""
    if videos:
        from dist_tpu_torch.data import sampling, transforms
        from dist_tpu_torch.data.base_dataset import probe_video, read_video

        clips = []
        for path in videos:
            total, fps = probe_video(path)
            idx = sampling.get_frame_indices(
                cfg, total, fps or 30.0, 0, 1,
                rng=np.random.default_rng(0), random_sample=False)
            clips.append(transforms.kinetics_resized_crop_controlled(
                read_video(path, idx), cfg.DATA.TEST_SCALE,
                cfg.DATA.TEST_CROP_SIZE, 1, 0))
        return np.ascontiguousarray(np.stack(clips))
    from dist_tpu_torch.data.builder import build_loader

    loader = build_loader(cfg, "test", device=device)
    try:
        it = iter(loader)
        try:
            return np.asarray(next(it)["video"])
        finally:
            it.close()
    finally:
        loader.close()


def visualize(cfg, videos=None, device=None):
    """Dump the feature maps of ``cfg``'s model on :func:`video_batch`:
    (the files written, the forward's predictions, the clips)."""
    from dist_tpu_torch.utils.visualization import capture_and_dump

    model, text_features = load_model(cfg, device)
    video = video_batch(cfg, videos, device)
    written, preds = capture_and_dump(
        cfg, model, {"video": video, "text_features": text_features})
    return written, preds, video


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m dist_tpu_torch.tools.visualize_features",
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--videos", nargs="*", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    ap.add_argument("opts", nargs="*", default=[])
    args = ap.parse_args(argv)

    from dist_tpu_torch.config import load_config

    cfg = load_config(args.cfg, list(args.opts), make_output_dir=False)
    written, _, _ = visualize(cfg, args.videos, args.device)
    print(f"wrote {written} feature maps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
