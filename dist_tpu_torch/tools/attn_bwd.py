"""K1b, the attention backward, on the card: how far it lies from its
plain version, the control that its limits must see, and where its time
goes.

    python -m dist_tpu_torch.tools.attn_bwd errors [--seeds N]
    python -m dist_tpu_torch.tools.attn_bwd passes [--reps N]

errors    at each of :data:`SHAPES` (the CLIP fine-tune's train step, the
          L/14 step, the text tower's causal rows, a length past the
          whole-row lengths) in bf16 and at the train shape in fp32, seeds
          0 .. N-1 (default 1): the route, the kernel's error against
          :func:`~dist_tpu_torch.ops.attention.attention_qkv_bwd_plain`
          (:func:`thirds_err`), the control's
          (:func:`bwd_without_rowsum`) and whether it breaks
          :data:`BWD_LIMITS`. One JSON line per case.
passes    at the train shape (``SHAPES[0]``) in bf16, for each route that
          takes it (whole_row, the rule's, and streaming, on request): the
          whole backward, pass dq alone and pass dkv alone, each pass on
          the scratch a whole backward filled first
          (:func:`~dist_tpu_torch.ops.attention.bwd_launch`), timed with
          CUDA events over N launches (default 20) after warm-up
          (``utils.profiling.time_calls``); with each pass's blocks per SM,
          shared memory and ptxas registers and spill bytes. One JSON line
          per route.

Needs the CUDA card and nvcc.
"""

import argparse
import json
import re

import torch

from dist_tpu_torch.ops import _build
from dist_tpu_torch.ops import attention as att
from dist_tpu_torch.utils.profiling import time_calls

# (B, L, heads, head dim, causal): the CLIP ViT-B/16 fine-tune's train
# step (32 clips x 8 frames), ViT-L/14's (32 x 32 frames), the text
# tower's 174 prompts, ViT-L/14 at 336 px
SHAPES = ((256, 197, 12, 64, False), (1024, 257, 16, 64, False),
          (174, 77, 8, 64, True), (8, 577, 16, 64, False))

# K1b against its plain version: max |err| over the largest |plain| of
# each third (dQ, dK, dV), the worst third.
#   fp32  sums in another order, fp32 throughout (the CPU's plain version
#         against the JAX package's vjp reads up to 8.7e-7,
#         tests/test_torch_port_attention_bwd.py)
#   bf16  dS enters the tensor cores rounded to bf16 where the plain
#         version keeps it in fp32 (2^-9 relative a term), P and dP are
#         rounded to bf16 on both sides from fp32 values that may differ
#         in the last bit (a flip moves a term by 2^-8 of it), and each
#         output is rounded to bf16 (one step, 2^-8 of it)
# On an H100 (seed 0 of ``errors``' cases): bf16 1.4e-3-6.8e-3, fp32
# 1.9e-7-3.3e-7. The control, dS = P dP (the rowsum term dropped), reads
# 0.17-2.26 on dQ and dK: 10 times the bf16 limit or more.
BWD_LIMITS = {"float32": 1e-5, "bfloat16": 2 ** -6}


def bwd_without_rowsum(qkv, dout, num_heads, causal=False):
    """The control: :func:`attention_qkv_bwd_plain` with dS = P dP, the
    ``rowsum(P dP)`` term dropped."""
    b, l, d3 = qkv.shape
    d = d3 // 3
    hd = d // num_heads
    s = hd ** -0.5
    q, k, v = (t.reshape(b, l, num_heads, hd).float()
               for t in qkv.split(d, dim=-1))
    logits = torch.einsum("blhd,bmhd->bhlm", q * s, k)
    if causal:
        logits = logits + torch.full((l, l), float("-inf"),
                                     device=qkv.device).triu(1)
    p = torch.softmax(logits, dim=-1)
    do = dout.reshape(b, l, num_heads, hd).float()
    dv = torch.einsum("bhlm,blhd->bmhd", p.to(qkv.dtype).float(), do)
    ds = p * torch.einsum("blhd,bmhd->bhlm", do, v).to(qkv.dtype).float()
    dq = torch.einsum("bhlm,bmhd->blhd", ds, k) * s
    dk = torch.einsum("bhlm,blhd->bmhd", ds, q * s)
    return torch.cat([t.reshape(b, l, d).to(qkv.dtype) for t in (dq, dk, dv)],
                     dim=-1)


def thirds_err(got, want):
    """[dQ, dK, dV]: max |got - want| over the largest |want| of each
    third of the (B, L, 3D) gradients (an all-zero third, dQ and dK at L
    = 1, over 1e-30)."""
    d = want.shape[-1] // 3
    out = []
    for i in range(3):
        g = got[..., i * d:(i + 1) * d].float()
        w = want[..., i * d:(i + 1) * d].float()
        if not bool(torch.isfinite(g).all()):
            out.append(float("inf"))
            continue
        out.append(float((g - w).abs().max())
                   / max(float(w.abs().max()), 1e-30))
    return out


def inputs(b, l, heads, hd, dtype, seed, device="cuda"):
    """Seeded qkv (B, L, 3D) and cotangent (B, L, D) on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d = heads * hd
    qkv = torch.randn((b, l, 3 * d), generator=gen, device=device).to(dtype)
    dout = torch.randn((b, l, d), generator=gen, device=device).to(dtype)
    return qkv, dout


def reading(qkv, dout, heads, causal):
    """{"route", "kernel_err": thirds, "control_err": thirds, "limit",
    "max_abs_err", "again_equal": bool, "pass"} of one case: the kernel
    twice (bit for bit) on the rule's route, its plain version and the
    control."""
    got = att.attention_qkv_bwd(qkv, dout, heads, causal)
    again = att.attention_qkv_bwd(qkv, dout, heads, causal)
    want = att.attention_qkv_bwd_plain(qkv, dout, heads, causal)
    control = bwd_without_rowsum(qkv, dout, heads, causal)
    limit = BWD_LIMITS[str(qkv.dtype).split(".")[-1]]
    kernel, ctrl = thirds_err(got, want), thirds_err(control, want)
    equal = bool(torch.equal(got, again))
    b, l, d3 = qkv.shape
    route = att.attention_bwd_route(l, d3 // 3 // heads, qkv.dtype)
    return {"route": route, "kernel_err": kernel, "control_err": ctrl,
            "limit": limit,
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "again_equal": equal,
            "pass": max(kernel) <= limit and max(ctrl) > limit and equal}


def errors(seeds):
    cases = [(s, torch.bfloat16) for s in SHAPES] + [(SHAPES[0],
                                                      torch.float32)]
    for (b, l, heads, hd, causal), dtype in cases:
        for seed in range(seeds):
            qkv, dout = inputs(b, l, heads, hd, dtype, seed)
            rec = reading(qkv, dout, heads, causal)
            print(json.dumps({"shape": [b, l, 3 * heads * hd],
                              "heads": heads, "causal": causal,
                              "dtype": str(dtype).split(".")[-1],
                              "seed": seed, **rec}), flush=True)
            del qkv, dout
            torch.cuda.empty_cache()


def instance_usage(l, hd, dtype, causal, route=None):
    """{"dq", "dkv": {"instance", "registers", "spill_bytes"}}: ptxas's
    usage of the two kernels K1b launches at length ``l``, head dim
    ``hd``, ``dtype`` and mask on ``route`` (by default the rule's), from
    the last build's log."""
    route = route or att.attention_bwd_route(l, hd, dtype)
    if route == "whole_row":
        lp = next(p for p in att.WHOLE_ROW_LENS if l <= p)
        pat = (rf"attention_bwd_(dq|dkv)_wr_kernelILi{hd}ELi{lp}ELb"
               rf"{int(causal)}E")
        tag = f"<{hd}, {lp}, {str(bool(causal)).lower()}>"
    else:
        t = "13__nv_bfloat16" if route == "streaming" else "f"
        pat = rf"attention_bwd_(dq|dkv)_kernelI{t}Li{hd}E"
        tag = f"<{'bf16' if route == 'streaming' else 'float'}, {hd}>"
    out = {}
    for mangled, v in _build.ptxas_usage("attention_bwd").items():
        m = re.search(pat, mangled)
        if m:
            wr = "_wr" if route == "whole_row" else ""
            out[m[1]] = {"instance": f"attention_bwd_{m[1]}{wr}_kernel{tag}",
                         "registers": v.get("registers"),
                         "spill_bytes": v.get("spill_stores", 0)
                         + v.get("spill_loads", 0)}
    if set(out) != {"dq", "dkv"}:
        raise RuntimeError(f"no ptxas usage of K1b's {route} instances at "
                           f"L={l}, hd {hd}, {dtype}, causal {causal}")
    return out


def passes(reps):
    b, l, heads, hd, causal = SHAPES[0]
    dt = torch.bfloat16
    qkv, dout = inputs(b, l, heads, hd, dt, 0)
    for route in ("whole_row", "streaming"):
        dqkv = torch.empty_like(qkv)
        stats = torch.empty((3, b, heads, l), dtype=torch.float32,
                            device=qkv.device)
        rec = {"shape": [b, l, 3 * heads * hd], "heads": heads,
               "causal": causal, "dtype": "bfloat16", "route": route,
               "device": torch.cuda.get_device_name(0)}
        for which in ("both", "dq", "dkv"):
            rec[f"{which}_ms"] = time_calls(lambda: att.bwd_launch(
                qkv, dout, dqkv, stats, heads, causal, route, which), "cuda",
                reps)[1]
        rec.update(blocks_per_sm=att.bwd_blocks_per_sm(hd, dt, l, route,
                                                       causal),
                   smem_bytes=att.bwd_smem_bytes(hd, dt, l, route),
                   ptxas=instance_usage(l, hd, dt, causal, route))
        print(json.dumps(rec), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("command", choices=["errors", "passes"])
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attn_bwd needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.command == "errors":
        errors(args.seeds)
    else:
        passes(args.reps)


if __name__ == "__main__":
    main()
