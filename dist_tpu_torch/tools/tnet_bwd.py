"""K3, the TemporalNet backward, on the card: how far its bf16 route lies
from the plain version, and where its time goes.

    python -m dist_tpu_torch.tools.tnet_bwd errors [--seeds N]
    python -m dist_tpu_torch.tools.tnet_bwd variants [--reps N]

errors    bf16, at each of :data:`SHAPES` (the train step's and the card
          tests') and seeds 0 .. N-1 (default 3): per output, the kernel's
          max abs error over max |plain| (``max_rel``) and relative L2 error
          (``rel_l2``) against the plain version (fp32 inside), and the same
          readings against the control (the plain version with w2's (0, 0)
          tap zeroed). One JSON line per case, then the worst kernel
          reading and the least control reading of each output, and
          whether the control breaks 3 times the worst in every case.
variants  text variants of ``csrc/temporal_net.cu`` (built as
          ``tools/attn_variants.py`` builds its own): ``shipped``,
          ``copies_only`` (the bf16 route's gathers and epilogues, no
          ldmatrix or mma) and ``math_only`` (the products on whatever
          shared memory holds, no gathers), K3 bf16 at the train shape,
          timed in two rounds, with the ptxas registers and spill bytes of
          the P = 96 instances; then the shipped kernel's launches one by
          one under ``torch.profiler`` (device ms per call, by kernel).

Needs the CUDA card and nvcc.
"""

import argparse
import json
import re

import torch

from dist_tpu_torch.ops import _build
from dist_tpu_torch.ops import temporal_net as tn
from dist_tpu_torch.tools import attn_variants
from dist_tpu_torch.utils.profiling import time_calls

NAMES = ("dx", "dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2")
# (x's shape, F, k): the train step's, then the card tests'
TRAIN = ((32, 16, 14, 14, 96), 96, 3)
SHAPES = (TRAIN, ((2, 16, 14, 14, 96), 96, 3), ((2, 5, 7, 9, 16), 16, 3),
          ((1, 5, 3, 7, 40), 24, 5), ((3, 2, 14, 14, 128), 128, 1))

_MMA_STAGE = "    rows_times_weights<P>(Rs + warp * 16 * LD, Rs + BM * LD, acc);"
_MMA_WGRAD = ("      if (warp < P / 16) a_t_b<P>(tile_a(i & 1), "
              "tile_a(i & 1) + BM * LD, warp * 16, acc);")
_COPY_ROWS = ("    cp_async16(dst + r * LD + ch * 8, src + (ok ? (size_t)s * K "
              "+ ch * 8 : 0), ok);")
_COPY_WTS = "      cp_async16(Ws + r * LD + ch * 8, w + r * P + ch * 8, true);"


# csrc/temporal_net.cu's k3::Stage values by name: K3's A-D, K2's Af and F
STAGES = ("A", "B", "C", "D", "Af", "F")


def instance_name(mangled):
    """``k3_stage_kernel<96, B>`` for the mangled name of a kernel of the
    bf16 routes (K3's and K2's): the stage's number as its name, the
    prepare kernel's flag as ``bwd`` or ``fwd``."""
    m = re.search(r"(k3_[a-z_]+?_kernel)(?:I((?:L[ib]\d+E)+)E)?", mangled)
    if not m:
        return mangled
    if not m[2]:
        return m[1]
    args = []
    for kind, v in re.findall(r"L([ib])(\d+)E", m[2]):
        if kind == "b":
            args.append(("bwd", "fwd")[int(v)])
        else:
            args.append(STAGES[int(v)] if args else v)
    return f"{m[1]}<{', '.join(args)}>"


def _off(line):
    return (line, "  // " + line.strip(), 1)


# name: [(old, new, count)] on csrc/temporal_net.cu
VARIANTS = {
    "shipped": [],
    "copies_only": [_off(_MMA_STAGE), _off(_MMA_WGRAD)],
    "math_only": [_off(_COPY_ROWS), _off(_COPY_WTS)],
}


def inputs(shape, f, k, seed, dtype):
    """x, the cotangent and the block's parameters on the card, seeded, in
    ``chip_smoke.py``'s order and scales."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]

    def rnd(*s, scale=1.0):
        return torch.randn(s, generator=gen, device="cuda") * scale

    x = rnd(*shape).to(dtype)
    g = rnd(*shape).to(dtype)
    params = (1.0 + rnd(c, scale=0.1), rnd(c, scale=0.1),
              rnd(k, 1, 1, c, f, scale=(k * c) ** -0.5), rnd(f, scale=0.1),
              rnd(1, 3, 3, f, c, scale=(9 * f) ** -0.5), rnd(c, scale=0.1))
    return x, g, params


def control_params(params):
    """The block's parameters with w2's (0, 0) tap zeroed: a kernel that
    skipped one of its nine spatial taps."""
    p = list(params)
    p[4] = p[4].clone()
    p[4][0, 0, 0] = 0
    return tuple(p)


def errors(got, want, names=NAMES):
    """{output: {"max_rel", "rel_l2"}}: max |got - want| over max |want|
    and ||got - want|| / ||want||, in fp64, for the outputs ``names``."""
    out = {}
    for name, a, b in zip(names, got, want):
        a, b = a.double(), b.double()
        out[name] = {
            "max_rel": float((a - b).abs().max()) / float(b.abs().max()),
            "rel_l2": float((a - b).norm()) / float(b.norm())}
    return out


def breaches(reading, limits):
    """[(output, metric, value)] of ``reading`` (:func:`errors`) above
    ``limits`` ({output: {metric: limit}})."""
    return [(name, m, reading[name][m]) for name, lims in limits.items()
            for m, lim in lims.items() if reading[name][m] > lim]


def cmd_errors(args):
    worst = {n: {"max_rel": 0.0, "rel_l2": 0.0} for n in NAMES}
    least = {n: {"max_rel": float("inf"), "rel_l2": float("inf")}
             for n in NAMES}
    controls = []
    for shape, f, k in SHAPES:
        for seed in range(args.seeds):
            x, g, params = inputs(shape, f, k, seed, torch.bfloat16)
            got = tn.fused_temporal_net_bwd(x, g, *params)
            kern = errors(got, tn.temporal_net_bwd_plain(x, g, *params))
            ctrl = errors(got, tn.temporal_net_bwd_plain(
                x, g, *control_params(params)))
            for n in NAMES:
                for m in ("max_rel", "rel_l2"):
                    worst[n][m] = max(worst[n][m], kern[n][m])
                    least[n][m] = min(least[n][m], ctrl[n][m])
            controls.append(ctrl)
            print(json.dumps({"shape": list(shape), "f": f, "k": k,
                              "seed": seed, "kernel": kern,
                              "control": ctrl}), flush=True)
    limits = {n: {m: 3 * v for m, v in w.items()} for n, w in worst.items()}
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "worst": worst,
        "control_least": least, "limits_3x": limits,
        "control_breaks_every_case": all(breaches(c, limits)
                                         for c in controls)}), flush=True)


def profile_calls(fn, calls=5):
    """{kernel name: device ms per call of ``fn``} over ``calls`` calls, or
    None if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = getattr(evt, "cuda_time_total", 0)
        if us and "_kernel" in evt.key:
            out[evt.key[:120]] = us / 1e3 / calls
    return out or None


def cmd_variants(args):
    libs = attn_variants.build_all("temporal_net", VARIANTS, tn._SIGNATURES)
    (shape, f, k) = TRAIN
    x, g, params = inputs(shape, f, k, 0, torch.bfloat16)
    want = tn.fused_temporal_net_bwd(x, g, *params)
    device = torch.cuda.get_device_name(0)
    for rnd in range(2):
        for name, lib in libs.items():
            rec = {"variant": name, "round": rnd, "device": device,
                   "ms": time_calls(lambda: tn.launch_bwd(lib, x, g, *params),
                                    "cuda", args.reps)[1]}
            if rnd == 0:
                usage = _build.parse_ptxas(
                    attn_variants.variant_log(name, "temporal_net"))
                rec["ptxas"] = {instance_name(key): [
                    v.get("registers"),
                    v.get("spill_stores", 0) + v.get("spill_loads", 0)]
                    for key, v in usage.items()
                    if "k3_" in key and ("ILi96E" in key or "ILi" not in key)}
                if name == "shipped":
                    got = tn.launch_bwd(lib, x, g, *params)
                    rec["equal_to_the_built_kernel"] = all(
                        bool(torch.equal(a, b)) for a, b in zip(got, want))
            print(json.dumps(rec), flush=True)
    profile = profile_calls(lambda: tn.fused_temporal_net_bwd(x, g, *params))
    print(json.dumps({"profile": profile, "device": device,
                      "shape": list(shape)}), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("errors")
    p.add_argument("--seeds", type=int, default=3)
    p = sub.add_parser("variants")
    p.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tnet_bwd: needs the CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    {"errors": cmd_errors, "variants": cmd_variants}[args.cmd](args)


if __name__ == "__main__":
    main()
