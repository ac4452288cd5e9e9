"""End-to-end input-pipeline benchmark on real disk video (port of
``tools/bench_pipeline.py``).

Writes N small mp4s (once; kept in the video directory), then measures:
  1. loader-only clips/s (decode -> sample -> crop -> batch),
  2. loader + device overlapped eval clips/s (the production loop
     shape): the flagship's eval forward through the port, K1 and K2 on
     the card (``--device cpu``: the plain versions on the CPU).

Prints one JSON line per measurement, with the JAX tool's keys.

    python -m dist_tpu_torch.tools.bench_pipeline [n_videos] \\
        [--video-dir DIR] [--device cpu]

Environment, as the JAX tool: ``BENCH_BATCH`` (8), ``BENCH_DEVICE`` (1;
0 measures the loader alone), ``BENCH_SWEEP=1,2,4,8`` with
``BENCH_WORKER_TYPE=thread|process|both`` (the loader's clips/s over
worker counts), ``BENCH_AUG=1`` (the train split with RandAugment).

The videos are written by the port's mp4 writer (``data/videoenc.cpp``)
and read by its native decoder (``data/videodec``): both need FFmpeg's
libraries. Where they are absent the tool raises at once, with the
decoder's or the writer's ``status()``.
"""

import argparse
import json
import os
import sys
import tempfile
import time

N_VIDEOS = 48
RES = (256, 256)
N_FRAMES = 48
FPS = 30.0
FLAGSHIP = "configs/projects/dist/ssv2/vit-b16-8+16f.yaml"
LIST_FILES = ("kinetics400_test_list.txt", "kinetics400_train_list.txt")


def _repo():
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def check_ffmpeg():
    """Raise, with the reason, where the native decoder or mp4 writer
    does not build."""
    from dist_tpu_torch.data import native_decoder, native_encoder

    for name, mod in (("native video decoder", native_decoder),
                      ("native mp4 writer", native_encoder)):
        state = mod.status()
        if state != "native":
            raise RuntimeError(
                f"bench_pipeline needs FFmpeg's libraries: the {name} is "
                f"{state}")


def make_videos(video_dir, n_videos):
    """``n_videos`` mp4s of ``N_FRAMES`` frames at ``RES`` and 30 fps, each
    ``np.roll`` of one seeded random frame, and both split lists (the
    ``BENCH_AUG`` sweep measures the train pipeline)."""
    import numpy as np

    from dist_tpu_torch.data.native_encoder import VideoWriter

    os.makedirs(video_dir, exist_ok=True)
    lines = []
    for i in range(n_videos):
        path = os.path.join(video_dir, f"v{i:04d}.mp4")
        lines.append(f"v{i:04d}.mp4 {i % 10}")
        if os.path.exists(path):
            continue
        rng = np.random.default_rng(i)
        base = rng.integers(0, 256, (RES[1], RES[0], 3), np.uint8)
        tmp = path + ".part.mp4"
        with VideoWriter(tmp, FPS, RES) as wr:
            for t in range(N_FRAMES):
                wr.write(np.roll(base, t * 3, axis=1))
        os.replace(tmp, path)
    for name in LIST_FILES:
        with open(os.path.join(video_dir, name), "w") as f:
            f.write("\n".join(lines))


def load_cfg(video_dir, batch, workers=None, worker_type=None):
    """The flagship config reading the bench videos as Kinetics-400, one
    view a video, with the fused TemporalNet (K2)."""
    from dist_tpu_torch.config import load_config

    opts = [
        "TEST.DATASET", "kinetics400",
        "TRAIN.DATASET", "kinetics400",
        "TEST.BATCH_SIZE", str(batch),
        "TRAIN.BATCH_SIZE", str(batch),
        "TEST.NUM_ENSEMBLE_VIEWS", "1",
        "TEST.NUM_SPATIAL_CROPS", "1",
        "DATA.DATA_ROOT_DIR", video_dir,
        "DATA.ANNO_DIR", video_dir,
        "DATA.DATASET_LABEL_TEXT.ENABLE", "false",
        "TPU.FUSED_TEMPORAL_NET", "true",
    ]
    if workers is not None:
        opts += ["DATA_LOADER.NUM_WORKERS", str(workers)]
    if worker_type is not None:
        opts += ["DATA_LOADER.WORKER_TYPE", worker_type]
    if os.environ.get("BENCH_AUG", "0") == "1":
        opts += ["AUGMENTATION.AUTOAUGMENT.ENABLE", "true"]
    return load_config(os.path.join(_repo(), FLAGSHIP), opts=opts,
                       make_output_dir=False)


def measure_loader(cfg, worker_type, n_videos, device):
    """One pass of the loader: prints and returns its JSON line, and the
    loader."""
    from dist_tpu_torch.data.builder import build_loader

    aug = os.environ.get("BENCH_AUG", "0") == "1"
    # augmentation runs on the train split alone, so the aug sweep
    # measures the train pipeline
    split = "train" if aug else "test"
    loader = build_loader(cfg, split, device=device)
    n = 0
    if worker_type == "process":
        next(iter(loader))  # exclude worker spawn + dataset rebuild
    t0 = time.perf_counter()
    for batch in loader:
        n += batch["video"].shape[0]
    dt = time.perf_counter() - t0
    line = {"metric": "loader_clips_per_sec", "value": round(n / dt, 2),
            "videos": n_videos, "workers": loader.num_workers,
            "worker_type": worker_type, "split": split, "aug": aug,
            "host_cores": os.cpu_count()}
    print(json.dumps(line), flush=True)
    return line, loader


def measure_e2e(cfg, loader, n_videos, batch, device):
    """The loader overlapped with the flagship's eval forward on
    ``device`` (random weights, seeded label-text features): prints and
    returns its JSON line."""
    import torch

    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.tasks.state import make_eval_step, to_device

    model = build_model(cfg, device=device)
    gen = torch.Generator().manual_seed(0)
    tf = torch.randn((int(cfg.VIDEO.HEAD.NUM_CLASSES), 512),
                     generator=gen).to(model.device)
    step = make_eval_step(model, cfg)
    sample = next(iter(loader))
    out = step({"video": to_device(sample["video"], model.device),
                "text_features": tf})["preds"]       # warm-up
    out[0, :1].cpu()
    n = 0
    t0 = time.perf_counter()
    for b in loader:
        out = step({"video": to_device(b["video"], model.device),
                    "text_features": tf})["preds"]
        n += b["video"].shape[0]
    out[0, :1].cpu()
    dt = time.perf_counter() - t0
    line = {"metric": "e2e_clips_per_sec", "value": round(n / dt, 2),
            "videos": n_videos, "batch": batch}
    print(json.dumps(line), flush=True)
    return line


def run(n_videos=N_VIDEOS, video_dir=None, device=None):
    """The whole tool: its JSON lines as a list."""
    from dist_tpu_torch.utils.device import resolve_device

    batch = int(os.environ.get("BENCH_BATCH", "8"))
    device_eval = os.environ.get("BENCH_DEVICE", "1") == "1"
    device = resolve_device(device)
    check_ffmpeg()
    video_dir = video_dir or os.path.join(tempfile.gettempdir(),
                                          "dist_tpu_torch_bench_videos")
    make_videos(video_dir, n_videos)

    lines = []
    sweep = os.environ.get("BENCH_SWEEP")
    if sweep:
        kind = os.environ.get("BENCH_WORKER_TYPE", "thread")
        kinds = ("thread", "process") if kind == "both" else (kind,)
        for k in kinds:
            for w in [int(s) for s in sweep.split(",")]:
                line, loader = measure_loader(
                    load_cfg(video_dir, batch, w, k), k, n_videos, device)
                loader.close()
                lines.append(line)
        return lines

    cfg = load_cfg(video_dir, batch)
    line, loader = measure_loader(cfg, "thread", n_videos, device)
    lines.append(line)
    try:
        if device_eval:
            lines.append(measure_e2e(cfg, loader, n_videos, batch, device))
    finally:
        loader.close()
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m dist_tpu_torch.tools.bench_pipeline",
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("n_videos", nargs="?", type=int, default=N_VIDEOS)
    ap.add_argument("--video-dir", default=None,
                    help="where the videos and lists are written (default: "
                         "dist_tpu_torch_bench_videos in the temporary "
                         "directory)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    run(args.n_videos, args.video_dir, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
