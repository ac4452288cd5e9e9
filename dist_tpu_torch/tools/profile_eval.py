"""Component timing of the flagship eval forward on the card, one JSON line
per component (port of ``tools/profile_eval.py``).

    python -m dist_tpu_torch.tools.profile_eval [components...] [--device cpu]

Components:
  matmul_peak   a chain of 8 bf16 (8192 x 8192) products (the card's GEMM
                rate, for calibration)
  full_eval     the eval step of tools.bench (uint8 normalisation, towers,
                side network, cosine classifier)
  tower_taps    the vision tower WITH per-layer taps (the DiST input path)
  tower_notaps  the vision tower without taps (the taps' cost)
  dist_net      the side network alone on seeded taps and video
  attn_kernel   the attention kernel (K1) at the tower's shape
                (B x 8 frames, 197, 3 x 768)
  ln_gelu       LayerNorm + QuickGELU at the tower's activation shape

Each line has ``component``, ``ms`` (mean per call between CUDA events,
after a first call, reported as ``first_call_s``, and 3 warm-up calls),
``device`` and, where the work is counted, ``tflops``. BENCH_CFG selects
the config (default the flagship ViT-B/16 8+16f) and BENCH_OPTS adds
overrides (for example ``TPU.FUSED_TEMPORAL_NET true``); the shapes
(tokens, width, heads, taps) come from its architecture in
``models/clip/model.py::ARCHITECTURES``. BENCH_BATCH (clips, default 8)
and BENCH_ITERS (calls per timing, default 40). Runs on the CUDA card;
``--device cpu`` runs on the CPU, where the times are the CPU's.
"""

import argparse
import json
import os
import sys

import torch

from dist_tpu_torch.utils.device import resolve_device
from dist_tpu_torch.utils.profiling import time_calls

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BATCH = int(os.environ.get("BENCH_BATCH", "8"))
ITERS = int(os.environ.get("BENCH_ITERS", "40"))
CFG = os.environ.get("BENCH_CFG",
                     "configs/projects/dist/ssv2/vit-b16-8+16f.yaml")
OPTS = os.environ.get("BENCH_OPTS", "").split()
MATMUL_N = 8192
COMPONENTS = ("matmul_peak", "full_eval", "tower_taps", "tower_notaps",
              "dist_net", "attn_kernel", "ln_gelu")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m dist_tpu_torch.tools.profile_eval",
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("components", nargs="*",
                    help=f"any of {', '.join(COMPONENTS)}; default all")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    unknown = set(args.components) - set(COMPONENTS)
    if unknown:
        ap.error(f"unknown components {sorted(unknown)}")
    device = resolve_device(args.device)
    want = set(args.components) or set(COMPONENTS)

    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.models.base.blocks import LayerNorm, quick_gelu
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.models.clip.model import ARCHITECTURES
    from dist_tpu_torch.ops.attention import fused_attention_qkv
    from dist_tpu_torch.tasks.state import _prep_video, make_eval_step

    cfg = load_config(os.path.join(REPO, CFG),
                      ["TRAIN.BATCH_SIZE", str(BATCH), *OPTS],
                      make_output_dir=False)
    arch = ARCHITECTURES[cfg.VIDEO.BACKBONE.META_ARCH_NAME]
    tokens = arch.grid_size ** 2 + 1
    width, heads = arch.vision_width, arch.vision_heads
    # operations of one sparse frame through the tower (a multiply-add is
    # 2): per layer qkv 6 T d^2, out-projection 2 T d^2, MLP 16 T d^2 and
    # attention 4 T^2 d
    frame_flops = arch.vision_layers * (
        24 * tokens * width ** 2 + 4 * tokens ** 2 * width)
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    def bench(name, fn, flops=None, iters=ITERS):
        first, ms = time_calls(fn, device, iters, warmup=3)
        rec = {"component": name, "ms": ms, "first_call_s": first,
               "device": card}
        if flops:
            rec["tflops"] = flops / (ms * 1e-3) / 1e12
        print(json.dumps(rec), flush=True)

    with torch.no_grad():
        if "matmul_peak" in want:
            n = MATMUL_N
            a = randn(n, n, dtype=torch.bfloat16)

            def chain():
                x = a
                for _ in range(8):
                    x = x @ a
                return x

            bench("matmul_peak", chain, flops=8 * 2 * n ** 3, iters=10)

        model = build_model(cfg, device=device)
        frames = int(cfg.DATA.NUM_INPUT_FRAMES)
        alpha = int(cfg.DATA.SPARSE_SAMPLE_ALPHA or 1)
        res = arch.image_resolution
        video_u8 = torch.randint(0, 255, (BATCH, frames, res, res, 3),
                                 generator=gen, device=device,
                                 dtype=torch.int32).to(torch.uint8)
        text_features = randn(int(cfg.VIDEO.HEAD.NUM_CLASSES), arch.embed_dim)
        tower_flops = frame_flops * BATCH * (frames // alpha)
        clip = model.module
        video_f = _prep_video(cfg, video_u8).float()
        bt = BATCH * frames // alpha

        if "full_eval" in want:
            step = make_eval_step(model, cfg)
            bench("full_eval", lambda: step({
                "video": video_u8, "text_features": text_features})["preds"],
                flops=tower_flops)
        for name, taps in (("tower_taps", True), ("tower_notaps", False)):
            if name in want:
                bench(name, lambda taps=taps: clip.visual(
                    video_f.to(clip.dtype), collect_taps=taps),
                    flops=tower_flops)
        if "dist_net" in want:
            n_sel = len(cfg.VIDEO.BACKBONE.DIST.SELECTED_LAYERS)
            taps = randn(n_sel, bt, tokens, width, dtype=torch.bfloat16)
            bench("dist_net", lambda: clip.dist_net(video_f, taps))
        if "attn_kernel" in want:
            qkv = randn(bt, tokens, 3 * width, dtype=torch.bfloat16)
            bench("attn_kernel_x1",
                  lambda: fused_attention_qkv(qkv, heads, False),
                  flops=4 * tokens * tokens * width * bt)
        if "ln_gelu" in want:
            x = randn(bt, tokens, width, dtype=torch.bfloat16)
            ln = LayerNorm(width).to(device)
            bench("ln_gelu_x1", lambda: quick_gelu(ln(x)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
