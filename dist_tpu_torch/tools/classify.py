"""Classify video files with a trained checkpoint: the multi-view
score-sum ensemble of the test task applied to files instead of a
dataset (port of ``tools/classify.py``).

    python -m dist_tpu_torch.tools.classify \\
        --cfg configs/projects/dist/k400/vit-b16-8+16f-eval.yaml \\
        --videos clip1.mp4 clip2.mp4 [--topk 5] [--device cpu] [KEY VALUE ...]

Checkpoint resolution follows the test task (TEST.CHECKPOINT_FILE_PATH >
last train checkpoint > TRAIN.CHECKPOINT_FILE_PATH); released ``.pyth``
checkpoints load as they are. Each video gives ``TEST.NUM_ENSEMBLE_VIEWS``
views (``DATA.SAMPLING_MODE``'s frame indices) of
``TEST.NUM_SPATIAL_CROPS`` crops; their scores are summed. Files are
decoded by the repository's native decoder (``data/native_decoder.py``),
which needs FFmpeg's libraries. Runs on the CUDA card; ``--device cpu``
runs on the CPU. Frame-parallel inference (``TPU.SHARD_FRAMES true``)
spreads the CLIP tower's frames over every local card, or over
``--devices`` (``cuda:0,cuda:1``; ``cpu,cpu`` on the CPU).
"""

import argparse
import sys

import numpy as np
import torch

_DUAL_HEAD = ("classify.py handles single-label heads; for EPIC verb/noun "
              "use runs/run.py with SUBMISSION.ENABLE true")


def load_classifier(cfg, device=None, devices=None):
    """(the model with the test task's checkpoint loaded, the label names
    or None, the label-text features or None) on ``device`` (default: the
    CUDA card); under ``TPU.SHARD_FRAMES`` its CLIP tower's frames spread
    over ``devices`` (default every local card, or ``[device]``), the
    first of which is the model's."""
    from dist_tpu_torch.data.base_dataset import resolve_label_texts
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.parallel import local
    from dist_tpu_torch.tasks.state import compute_text_features, load_pretrained
    from dist_tpu_torch.utils.checkpoint import load_test_checkpoint

    nc = cfg.VIDEO.HEAD.NUM_CLASSES
    if isinstance(nc, (list, tuple)):
        raise ValueError(_DUAL_HEAD)
    shard = local.check_shard_frames(cfg)
    if shard:
        devices = local.local_devices(device, devices)
        device = devices[0]
    model = build_model(cfg, device=device)
    load_pretrained(cfg, model)
    load_test_checkpoint(cfg, model)
    if shard:
        local.shard_frames(model, devices)
    names, tokens = resolve_label_texts(cfg, int(nc))
    return model, names, compute_text_features(model, tokens)


def decode_views(cfg, path):
    """The decoded frames (T, H, W, 3) uint8 of each of the
    ``TEST.NUM_ENSEMBLE_VIEWS`` views of the video at ``path``."""
    from dist_tpu_torch.data import sampling
    from dist_tpu_torch.data.base_dataset import probe_video, read_video

    total, fps = probe_video(path)
    fps = fps or 30.0
    views = int(cfg.TEST.NUM_ENSEMBLE_VIEWS)
    return [read_video(path, sampling.get_frame_indices(
        cfg, total, fps, v, views, rng=np.random.default_rng(0),
        random_sample=False)) for v in range(views)]


def score_video(cfg, model, text_features, view_frames):
    """The ensembled class scores (num_classes,) of one video from its
    decoded views: each view's ``TEST.NUM_SPATIAL_CROPS`` test crops, all
    clips through the eval step in one batch, their scores summed."""
    from dist_tpu_torch.data import transforms
    from dist_tpu_torch.tasks.state import make_eval_step

    crops = int(cfg.TEST.NUM_SPATIAL_CROPS)
    clips = [transforms.kinetics_resized_crop_controlled(
        frames, cfg.DATA.TEST_SCALE, cfg.DATA.TEST_CROP_SIZE, crops, s)
        for frames in view_frames for s in range(crops)]
    video = torch.from_numpy(np.ascontiguousarray(np.stack(clips)))
    preds = make_eval_step(model, cfg)(
        {"video": video.to(model.device),
         "text_features": text_features})["preds"]
    return preds.float().cpu().numpy().sum(axis=0)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m dist_tpu_torch.tools.classify", description=__doc__,
        formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--videos", nargs="+", required=True)
    ap.add_argument("--topk", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    ap.add_argument("--devices", default=None,
                    help="TPU.SHARD_FRAMES: the devices the frames spread "
                         "over, comma-separated (default: every local card)")
    ap.add_argument("opts", nargs="*", default=[])
    args = ap.parse_args(argv)

    from dist_tpu_torch.config import load_config

    cfg = load_config(args.cfg, list(args.opts), make_output_dir=False)
    model, label_names, text_features = load_classifier(
        cfg, args.device,
        args.devices.split(",") if args.devices else None)
    for path in args.videos:
        scores = score_video(cfg, model, text_features,
                             decode_views(cfg, path))
        print(f"\n{path}:")
        for rank, cls in enumerate(np.argsort(scores)[::-1][:args.topk], 1):
            name = label_names[cls] if label_names else f"class {cls}"
            print(f"  {rank}. {name}  (score {scores[cls]:.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
