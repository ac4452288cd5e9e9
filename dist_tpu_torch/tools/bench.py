"""Throughput of the flagship DiST ViT-B/16 8-frame model on one card
(port of ``bench.py``, which stays as it is).

    python -m dist_tpu_torch.tools.bench [--device cpu]

Prints one JSON line per metric, eval first:
  {"metric": "clips_per_sec_per_chip", "value": N, "unit": "clips/s",
   "vs_baseline": N, "device": ...}
  {"metric": "train_clips_per_sec_per_chip", ...}

Eval is the eval step (uint8 clips normalised on the card, both towers,
the side network, the cosine classifier against seeded label-text
features); train is ``make_train_step`` (forward, loss, backward, AdamW
updating the weights in place). Each runs WARMUP calls, then ITERS calls
on the host clock, ended by a synchronisation with the card: clips/s =
BATCH x ITERS / seconds. Random weights from the config's RANDOM_SEED.

``vs_baseline``: the reference published no throughput; the number is
normalised by a fixed budget of 32 clips/s/chip
(``REFERENCE_CLIPS_PER_SEC``) so that it compares across runs.

Env knobs: BENCH_BATCH (16), BENCH_ITERS (40), BENCH_WARMUP (2),
BENCH_MODE (eval | train | both), BENCH_CFG, BENCH_OPTS (dotted
overrides), BENCH_MEMSTATS (add the card's memory counters). Runs on the
CUDA card; ``--device cpu`` runs on the CPU, where the rates are the
CPU's.
"""

import argparse
import json
import os
import sys
import time

import torch

from dist_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REFERENCE_CLIPS_PER_SEC = 32.0
BATCH = int(os.environ.get("BENCH_BATCH", "16"))
ITERS = int(os.environ.get("BENCH_ITERS", "40"))
WARMUP = int(os.environ.get("BENCH_WARMUP", "2"))
MODE = os.environ.get("BENCH_MODE", "both")
CFG = os.environ.get("BENCH_CFG",
                     "configs/projects/dist/ssv2/vit-b16-8+16f.yaml")
OPTS = os.environ.get("BENCH_OPTS", "").split()


def _build(cfg, device):
    """(model, uint8 clips, label-text features) on ``device``."""
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.models.clip.model import ARCHITECTURES

    model = build_model(cfg, device=device)
    frames = int(cfg.DATA.NUM_INPUT_FRAMES)
    crop = int(cfg.DATA.TEST_CROP_SIZE or 224)
    arch = ARCHITECTURES[cfg.VIDEO.BACKBONE.META_ARCH_NAME]
    gen = torch.Generator(device=device).manual_seed(0)
    video = torch.randint(0, 255, (BATCH, frames, crop, crop, 3),
                          generator=gen, device=device,
                          dtype=torch.int32).to(torch.uint8)
    text = torch.randn((int(cfg.VIDEO.HEAD.NUM_CLASSES), arch.embed_dim),
                       generator=gen, device=device)
    return model, video, text


def _clips_per_sec(forward, device):
    def wait():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(1 + WARMUP):
        forward()
    wait()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        forward()
    wait()
    return BATCH * ITERS / (time.perf_counter() - t0)


def run(mode, cfg, built, device):
    from dist_tpu_torch.tasks.state import make_eval_step

    model, video, text = built
    if mode == "train":
        from dist_tpu_torch.optim.optimizer import construct_optimizer
        from dist_tpu_torch.tasks.state import (
            create_train_state,
            make_train_step,
        )

        optimizer, lr_fn = construct_optimizer(cfg, model.module,
                                               steps_per_epoch=100)
        state = create_train_state(model, optimizer)
        step = make_train_step(model, cfg, optimizer, lr_fn)
        batch = {"video": video, "text_features": text,
                 "labels": torch.zeros((BATCH,), dtype=torch.long,
                                       device=device)}

        def forward():
            return step(state, batch)["loss"]
    else:
        step = make_eval_step(model, cfg)

        def forward():
            return step({"video": video, "text_features": text})["preds"]

    clips_per_sec = _clips_per_sec(forward, device)
    out = {
        "metric": ("train_clips_per_sec_per_chip" if mode == "train"
                   else "clips_per_sec_per_chip"),
        "value": clips_per_sec,
        "unit": "clips/s",
        "vs_baseline": clips_per_sec / REFERENCE_CLIPS_PER_SEC,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "batch": BATCH,
    }
    if os.environ.get("BENCH_MEMSTATS") and device.type == "cuda":
        stats = torch.cuda.memory_stats(device)
        out["bytes_in_use"] = int(stats["allocated_bytes.all.current"])
        out["peak_bytes_in_use"] = int(torch.cuda.max_memory_allocated(device))
        out["bytes_limit"] = int(
            torch.cuda.get_device_properties(device).total_memory)
    return out


def main(argv=None):
    from dist_tpu_torch.config import load_config

    ap = argparse.ArgumentParser(
        prog="python -m dist_tpu_torch.tools.bench", description=__doc__,
        formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    device = resolve_device(ap.parse_args(argv).device)
    cfg = load_config(os.path.join(REPO, CFG),
                      ["TRAIN.BATCH_SIZE", str(BATCH)] + OPTS,
                      make_output_dir=False)
    built = _build(cfg, device)
    for mode in (("eval", "train") if MODE == "both" else (MODE,)):
        print(json.dumps(run(mode, cfg, built, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
