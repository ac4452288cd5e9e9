"""Microbenchmarks of the hot-path pieces, one JSON line per measurement
(port of ``tools/microbench.py``).

    python -m dist_tpu_torch.tools.microbench <subcommand> [names...] [--device cpu]

  attn       the attention kernel (K1, ``attn_shipped``) against the plain
             composition (``attn_plain``), SDPA as a yardstick
             (``attn_sdpa``) and the multi-row kernel (K4, ``attn_rows{nb}``
             for nb = 2, 4, 8); the ViT-B/16 tower shape (64, 197, 3 * 768)
             bf16, 12 heads
  stem       TemporalPatchStem: the shipped Conv3d against the two
             patchify-and-GEMM formulations; CLIP conv1 dense vs sparse
  conv33     TemporalNet's (1,3,3) conv: cuDNN against the shift-add
             matmul dual, forward + backward, after a max |difference| line
  int8       bf16 against int8 GEMMs (``torch._int_mm``) at the tower's
             four GEMM shapes (M = 12,608); library GEMMs both
  dist       DiST side-network components, forward
             (names: dist_full dist_full_fused stem temporal_net
              integration input_linear t2i i2t adapool)
  bwd        DiSTNetwork / stem forward + backward, unfused and fused,
             each without and with ``TPU.REMAT`` (the ladder's steps run
             again in the backward; names filter the variants; the
             fused-vs-unfused parity probe runs only with no names or the
             name ``parity``). The JAX tool's rolled and unrolled variants
             are a choice of XLA's compile with no eager counterpart.
  bwd_parts  forward + backward of one ladder step's modules (names as
             for ``dist``); ``ms`` is one module of one step
  train      the train step: full step, loss forward, loss forward +
             backward, optimizer only (BENCH_CFG selects the config,
             BENCH_OPTS adds overrides)

Timing (``dist_tpu_torch.utils.profiling.time_calls``): one first call,
reported as ``first_call_s`` (on the card it includes nvcc at a kernel's
first use and cuDNN's autotuning), two warm-up calls, then CUDA events
around OUTER runs of REPS calls; ``ms`` is the mean per call. PyTorch runs
eagerly, so the repetitions are plain repeated calls. Compare variants
only within one run. Every line names the ``device`` it ran on; a variant
that fails prints an ``error`` line and the tool exits 1.

Env knobs: REPS (calls per run), BENCH_BATCH (clips), BENCH_CFG and
BENCH_OPTS (``train``). Runs on the CUDA card; ``--device cpu`` runs on
the CPU, where the times are the CPU's.
"""

import argparse
import json
import os
import sys

import torch
import torch.nn.functional as F

from dist_tpu_torch.utils.device import resolve_device
from dist_tpu_torch.utils.profiling import time_calls

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REPS = int(os.environ.get("REPS", "20"))
OUTER = 5
BATCH = int(os.environ.get("BENCH_BATCH", "8"))
CFG = os.environ.get("BENCH_CFG",
                     "configs/projects/dist/ssv2/vit-b16-8+16f.yaml")
OPTS = os.environ.get("BENCH_OPTS", "").split()

# (B, L, heads, head dim) of the vision tower's attention: 8 clips of 8
# sparse frames, 197 tokens of ViT-B/16, 12 heads of 64
ATTN = (64, 197, 12, 64)
ATTN_ROWS = (2, 4, 8)
# the flagship's geometry (configs/projects/dist/ssv2/vit-b16-8+16f.yaml):
# 16 dense frames of 224^2, ViT-B/16 (patch 16, width 768, 12 layers,
# embedding 512), the side network's stem (t_patch 5, 96 channels), sparse
# frames every alpha = 2nd
GEOMETRY = {"frames": 16, "crop": 224, "patch": 16, "width": 768,
            "layers": 12, "embed": 512, "alpha": 2}
# the four GEMMs of a ViT-B/16 block at 64 frame rows x 197 tokens:
# (M, K, N) of qkv, out-projection, MLP up and down
INT8_SHAPES = ((12608, 768, 2304), (12608, 768, 768), (12608, 768, 3072),
               (12608, 3072, 768))


class Bench:
    """One run's device and repetitions; prints each record as a JSON line
    and keeps it in ``records``."""

    def __init__(self, device, reps=None, outer=OUTER):
        self.device = torch.device(device)
        self.reps = REPS if reps is None else reps
        self.outer = outer
        self.device_name = (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu")
        self.records = []

    def emit(self, rec):
        self.records.append(rec)
        print(json.dumps(rec), flush=True)

    def time(self, name, fn, ref=None, outer=None):
        """Time ``fn()``; with ``ref``, report max |fn() - ref()| and
        max |ref()| first."""
        try:
            rec = {"variant": name}
            if ref is not None:
                got, want = fn().float(), ref().float()
                rec["max_abs_diff"] = float((got - want).abs().max())
                rec["max_abs_ref"] = float(want.abs().max())
            first, ms = time_calls(fn, self.device, self.reps,
                                   outer=outer or self.outer)
            rec.update(ms=ms, first_call_s=first, device=self.device_name)
        except Exception as e:  # one variant's failure; main() exits 1
            rec = {"variant": name, "error": repr(e)[-300:]}
        self.emit(rec)

    def randn(self, *shape, dtype=torch.float32, seed=0, scale=1.0):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        x = torch.randn(shape, generator=gen, device=self.device)
        return (x * scale).to(dtype)

    def module(self, mod, seed=0):
        """``mod`` with the port's random weights (``init_weights``), on
        the device."""
        from dist_tpu_torch.models.base.blocks import init_weights

        init_weights(mod, torch.Generator().manual_seed(seed))
        return mod.to(self.device)


def _grads(out, params):
    """d(sum of every output, in fp32)/d params; None for a parameter the
    output does not reach."""
    outs = out if isinstance(out, tuple) else (out,)
    total = sum(o.float().sum() for o in outs)
    return torch.autograd.grad(total, params, allow_unused=True)


# ---------------------------------------------------------------- attn ----

def attn_input(device):
    """The seeded bf16 (B, L, 3D) input of ``attn``."""
    b, l, h, hd = ATTN
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randn((b, l, 3 * h * hd), generator=gen,
                       device=device).to(torch.bfloat16)


def cmd_attn(bench, _names):
    from dist_tpu_torch.ops.attention import (
        attention_qkv_plain,
        attention_qkv_rows,
        fused_attention_qkv,
    )

    b, l, h, hd = ATTN
    qkv = attn_input(bench.device)
    q, k, v = (qkv.view(b, l, 3, h, hd)[:, :, i].transpose(1, 2)
               for i in range(3))

    def shipped():
        return fused_attention_qkv(qkv, h, False)

    bench.time("attn_shipped", shipped)
    bench.time("attn_plain", lambda: attention_qkv_plain(qkv, h, False),
               ref=shipped)
    bench.time("attn_sdpa", lambda: F.scaled_dot_product_attention(q, k, v))
    for nb in ATTN_ROWS:
        bench.time(f"attn_rows{nb}",
                   lambda nb=nb: attention_qkv_rows(qkv, h, nb), ref=shipped)


# ---------------------------------------------------------------- stem ----

def cmd_stem(bench, _names):
    from dist_tpu_torch.models.base.blocks import Conv2d
    from dist_tpu_torch.models.dist.dist_net import (
        DiSTConfig,
        TemporalPatchStem,
    )

    g, dc = GEOMETRY, DiSTConfig(selected_layers=())
    p, tp, c, t = g["patch"], dc.t_patch_size, dc.temporal_dim, g["frames"]
    bf16 = torch.bfloat16
    video = bench.randn(BATCH, t, g["crop"], g["crop"], 3)
    stem = bench.module(TemporalPatchStem(c, tp, p))
    with torch.no_grad():
        kern = stem.weight.permute(2, 3, 4, 1, 0).to(bf16)  # (tp, p, p, 3, C)
        w_all = kern.reshape(tp, p * p * 3, c).permute(1, 0, 2).reshape(
            p * p * 3, tp * c)
        w_dh = kern.permute(1, 2, 3, 0, 4).reshape(p, p * 3, tp * c)

        def tail(y):
            # temporal shift-add over the tp lane slices, padded by tp // 2
            pad = tp // 2
            yp = F.pad(y, (0, 0, 0, 0, pad, pad))
            out = yp[:, 0:t, :, 0:c]
            for d in range(1, tp):
                out = out + yp[:, d:d + t, :, d * c:(d + 1) * c]
            return out

        def stem_conv3d():
            return stem(video.to(bf16)).flatten(2, 3)

        def stem_transpose():
            x = video.to(bf16)
            b, _, h, w, ci = x.shape
            x = x.reshape(b, t, h // p, p, w // p, p, ci).permute(
                0, 1, 2, 4, 3, 5, 6).reshape(b, t, (h // p) * (w // p),
                                             p * p * ci)
            return tail(x @ w_all)

        def stem_rows():
            x = video.to(bf16)
            b, _, h, w, ci = x.shape
            xb = x.reshape(b, t, h // p, p, w * ci)
            acc = None
            for dh in range(p):
                rows = xb[:, :, :, dh, :].reshape(b, t, h // p, w // p, p * ci)
                y = (rows @ w_dh[dh]).float()
                acc = y if acc is None else acc + y
            return tail(acc.to(bf16).reshape(b, t, -1, tp * c))

        bench.time("stem_conv3d", stem_conv3d)
        bench.time("stem_transpose", stem_transpose, ref=stem_conv3d)
        bench.time("stem_rows", stem_rows, ref=stem_conv3d)

        conv1 = bench.module(Conv2d(3, g["width"], p, stride=p, bias=False))
        frames = video.reshape(-1, g["crop"], g["crop"], 3).permute(0, 3, 1, 2)
        bench.time("tower_conv1_dense", lambda: conv1(frames.to(bf16)))
        bench.time("tower_conv1_sparse",
                   lambda: conv1(frames[::g["alpha"]].to(bf16)))


# -------------------------------------------------------------- conv33 ----

def cmd_conv33(bench, _names):
    from dist_tpu_torch.models.base.blocks import Conv3d

    c = 96
    hw = GEOMETRY["crop"] // GEOMETRY["patch"]
    x = bench.randn(BATCH, GEOMETRY["frames"], hw, hw, c,
                    dtype=torch.bfloat16)
    kern = bench.randn(1, 3, 3, c, c, dtype=torch.bfloat16, seed=1,
                       scale=0.05)
    conv = Conv3d(c, c, (1, 3, 3), padding=(0, 1, 1)).to(bench.device)
    with torch.no_grad():
        conv.weight.copy_(kern.permute(4, 3, 0, 1, 2))
        conv.bias.zero_()
    w_cat = kern.reshape(9, c, c).permute(1, 0, 2).reshape(c, 9 * c)

    def conv_fn(x):
        return conv(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)

    def mm_fn(x):
        _, _, h, w, _ = x.shape
        yp = F.pad(x @ w_cat, (0, 0, 1, 1, 1, 1))
        out = None
        for i in range(9):
            dy, dx = divmod(i, 3)
            sl = yp[:, :, dy:dy + h, dx:dx + w, i * c:(i + 1) * c]
            out = sl if out is None else out + sl
        return out + conv.bias.to(x.dtype)

    with torch.no_grad():
        diff = float((conv_fn(x).float() - mm_fn(x).float()).abs().max())
    bench.emit({"check": "max_abs_diff", "v": diff})
    xg = x.detach().requires_grad_()
    for name, f in (("conv33_fwd_bwd", conv_fn), ("mm33_fwd_bwd", mm_fn)):
        bench.time(name, lambda f=f: torch.autograd.grad(
            f(xg).float().sum(), xg)[0], outer=3)


# ---------------------------------------------------------------- int8 ----

def cmd_int8(bench, _names):
    for m, k, n in INT8_SHAPES:
        xb = bench.randn(m, k, dtype=torch.bfloat16)
        wb = bench.randn(k, n, dtype=torch.bfloat16, seed=1)
        xi = bench.randn(m, k, scale=10).to(torch.int8)
        wi = bench.randn(k, n, seed=1, scale=10).to(torch.int8)
        bench.time(f"bf16_{m}x{k}x{n}", lambda xb=xb, wb=wb: xb @ wb)
        bench.time(f"int8_{m}x{k}x{n}",
                   lambda xi=xi, wi=wi: torch._int_mm(xi, wi).float())


# ---------------------------------------------------------------- dist ----

def _dist_setup(bench):
    """The ladder's config and seeded inputs at the flagship geometry:
    (cfg, video, taps, x_temporal, mid)."""
    from dist_tpu_torch.models.dist.dist_net import DiSTConfig

    g = GEOMETRY
    cfg = DiSTConfig(selected_layers=tuple(range(g["layers"])),
                     num_frames=g["frames"], alpha=g["alpha"])
    hw = g["crop"] // g["patch"]
    bt = BATCH * cfg.sparse_frames
    bf16 = torch.bfloat16
    video = bench.randn(BATCH, g["frames"], g["crop"], g["crop"], 3)
    taps = bench.randn(g["layers"], bt, hw * hw + 1, g["width"], dtype=bf16,
                       seed=1)
    x_temporal = bench.randn(BATCH, g["frames"], hw, hw, cfg.temporal_dim,
                             dtype=bf16, seed=2)
    mid = bench.randn(bt, hw * hw + 1, cfg.integration_dim, dtype=bf16,
                      seed=3)
    return cfg, video, taps, x_temporal, mid


def _parts(bench, cfg, video, taps, x_temporal, mid):
    """{name: (module, args)} of one ladder step's modules, as the JAX
    tool's ``dist`` and ``bwd_parts`` build them."""
    from dist_tpu_torch.models.base.blocks import Linear
    from dist_tpu_torch.models.dist.dist_net import (
        AdaPooling,
        Integration2Temporal,
        IntegrationNetwork,
        Temporal2Integration,
        TemporalNet,
        TemporalPatchStem,
    )

    c = cfg.integration_dim
    top_cls = bench.randn(BATCH, 1, c, dtype=torch.bfloat16, seed=4)
    sp_cls = bench.randn(mid.shape[0], 1, c, dtype=torch.bfloat16, seed=5)
    return {
        "stem": (TemporalPatchStem(cfg.temporal_dim, cfg.t_patch_size,
                                   cfg.s_patch_size),
                 (video.to(torch.bfloat16),)),
        "temporal_net": (TemporalNet(cfg), (x_temporal,)),
        "integration": (IntegrationNetwork(cfg), (mid,)),
        "input_linear": (Linear(GEOMETRY["width"], c), (taps[0],)),
        "t2i": (Temporal2Integration(cfg), (x_temporal,)),
        "i2t": (Integration2Temporal(cfg), (mid,)),
        "adapool": (AdaPooling(cfg), (mid, top_cls, sp_cls)),
    }


def _dist_net(bench, cfg, fused):
    from dist_tpu_torch.models.dist.dist_net import DiSTNetwork

    return bench.module(DiSTNetwork(cfg, d_model=GEOMETRY["width"],
                                    output_dim=GEOMETRY["embed"],
                                    fused_temporal=fused))


def cmd_dist(bench, names):
    cfg, video, taps, x_temporal, mid = _dist_setup(bench)
    want = set(names) or {"dist_full", "dist_full_fused", "stem",
                          "temporal_net", "integration", "input_linear",
                          "t2i", "i2t", "adapool"}
    with torch.no_grad():
        for name, fused in (("dist_full", False), ("dist_full_fused", True)):
            if name in want:
                net = _dist_net(bench, cfg, fused)
                bench.time(name, lambda net=net: net(video, taps))
        for name, (mod, args) in _parts(bench, cfg, video, taps, x_temporal,
                                        mid).items():
            if name in want:
                mod = bench.module(mod)
                bench.time(name, lambda mod=mod, args=args: mod(*args))


# ----------------------------------------------------------------- bwd ----

def cmd_bwd(bench, names):
    cfg, video, taps, _, _ = _dist_setup(bench)
    want = set(names)
    net = _dist_net(bench, cfg, False)
    params = list(net.parameters())

    def set_fused(fused):
        for tnet in net.temporal_nets:
            tnet.fused = fused

    for name, fused, remat in (
            ("dist_fwd_bwd", False, False), ("dist_fwd_bwd_fused", True, False),
            ("dist_fwd_bwd_remat", False, True),
            ("dist_fwd_bwd_remat_fused", True, True)):
        if not want or name in want:
            set_fused(fused)
            net.remat = remat
            bench.time(name, lambda: _grads(net(video, taps), params),
                       outer=3)

    # the fused TemporalNet ladder (K2) against the unfused one (cuDNN)
    # with the same weights, on this device
    if not want or "parity" in want:
        try:
            with torch.no_grad():
                set_fused(False)
                o1 = net(video, taps).float()
                set_fused(True)
                o2 = net(video, taps).float()
            bench.emit({"variant": "fused_vs_unfused_parity",
                        "max_abs_diff": float((o1 - o2).abs().max()),
                        "out_max": float(o1.abs().max())})
        except Exception as e:  # reported; main() exits 1
            bench.emit({"variant": "fused_vs_unfused_parity",
                        "error": repr(e)[-300:]})

    if not want or "stem_fwd_bwd" in want:
        from dist_tpu_torch.models.dist.dist_net import TemporalPatchStem

        stem = bench.module(TemporalPatchStem(
            cfg.temporal_dim, cfg.t_patch_size, cfg.s_patch_size))
        vid = video.to(torch.bfloat16)
        sparams = list(stem.parameters())
        bench.time("stem_fwd_bwd", lambda: _grads(stem(vid), sparams),
                   outer=3)


def cmd_bwd_parts(bench, names):
    """Forward + backward of each module of one ladder step at the
    flagship geometry: whether a module is off its bandwidth or GEMM
    floor. ``ms`` is one module of one step; the ladder runs 12."""
    cfg, video, taps, x_temporal, mid = _dist_setup(bench)
    want = set(names) or {"temporal_net", "integration", "input_linear",
                          "t2i", "i2t", "adapool", "stem"}
    for name, (mod, args) in _parts(bench, cfg, video, taps, x_temporal,
                                    mid).items():
        if name in want:
            mod = bench.module(mod)
            params = list(mod.parameters())
            bench.time(f"{name}_fwd_bwd",
                       lambda mod=mod, args=args, params=params: _grads(
                           mod(*args), params), outer=3)


# --------------------------------------------------------------- train ----

def cmd_train(bench, _names):
    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.models.clip.model import ARCHITECTURES
    from dist_tpu_torch.optim.losses import calculate_loss
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.tasks.state import (
        _prep_video,
        create_train_state,
        make_train_step,
    )

    cfg = load_config(os.path.join(REPO, CFG),
                      ["TRAIN.BATCH_SIZE", str(BATCH)] + OPTS,
                      make_output_dir=False)
    model = build_model(cfg, device=bench.device)
    frames = int(cfg.DATA.NUM_INPUT_FRAMES)
    crop = int(cfg.DATA.TRAIN_CROP_SIZE or 224)
    gen = torch.Generator(device=bench.device).manual_seed(0)
    video = torch.randint(0, 255, (BATCH, frames, crop, crop, 3),
                          generator=gen, device=bench.device,
                          dtype=torch.int32).to(torch.uint8)
    n_cls = int(cfg.VIDEO.HEAD.NUM_CLASSES)
    embed = ARCHITECTURES[cfg.VIDEO.BACKBONE.META_ARCH_NAME].embed_dim
    tf = bench.randn(n_cls, embed)
    labels = torch.zeros((BATCH,), dtype=torch.long, device=bench.device)
    optimizer, lr_fn = construct_optimizer(cfg, model.module,
                                           steps_per_epoch=100)
    state = create_train_state(model, optimizer)
    step = make_train_step(model, cfg, optimizer, lr_fn)
    batch = {"video": video, "labels": labels, "text_features": tf}
    bench.time("train_step_full", lambda: step(state, batch)["loss"],
               outer=3)

    trainable = [p for g in optimizer.param_groups for p in g["params"]]

    def loss_fn():
        preds, logits = model.apply({"video": _prep_video(cfg, video),
                                     "text_features": tf}, train=True)
        return calculate_loss(cfg, preds, logits, {"supervised": labels})[0]

    with torch.no_grad():
        bench.time("loss_fwd_only", loss_fn, outer=3)
    bench.time("loss_fwd_bwd", lambda: torch.autograd.grad(
        loss_fn(), trainable, allow_unused=True), outer=3)
    for p in trainable:
        p.grad = torch.zeros_like(p)
    bench.time("optimizer_only", optimizer.step, outer=3)


COMMANDS = {"attn": cmd_attn, "stem": cmd_stem, "conv33": cmd_conv33,
            "int8": cmd_int8, "dist": cmd_dist, "bwd": cmd_bwd,
            "bwd_parts": cmd_bwd_parts, "train": cmd_train}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m dist_tpu_torch.tools.microbench",
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("command", choices=sorted(COMMANDS))
    ap.add_argument("names", nargs="*")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    bench = Bench(resolve_device(args.device))
    COMMANDS[args.command](bench, args.names)
    return 1 if any("error" in r for r in bench.records) else 0


if __name__ == "__main__":
    sys.exit(main())
