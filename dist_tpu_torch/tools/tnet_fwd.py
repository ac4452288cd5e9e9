"""K2, the TemporalNet forward, on the card: how far its bf16 route lies
from the plain version, and where its time goes.

    python -m dist_tpu_torch.tools.tnet_fwd errors [--seeds N]
    python -m dist_tpu_torch.tools.tnet_fwd variants [--reps N]
    python -m dist_tpu_torch.tools.tnet_fwd host [--calls N]

errors    bf16, at each of :data:`SHAPES` (the train step's, the served
          batch's and the card tests') and seeds 0 .. N-1 (default 3): the
          kernel's max abs error over max |plain| (``max_rel``) and
          relative L2 error (``rel_l2``) against the plain version (fp32
          inside), and the same readings against the control (the plain
          version with w2's (0, 0) tap zeroed). One JSON line per case,
          then the worst kernel reading, the least control reading, and
          whether the control breaks 3 times the worst in every case.
variants  the text variants of ``csrc/temporal_net.cu`` that
          ``tnet_bwd variants`` builds (``shipped``, ``copies_only``,
          ``math_only``; K2's bf16 stages share their anchors with K3's),
          K2 bf16 at the train and serving shapes, timed in two rounds,
          with the ptxas registers and spill bytes of K2's P = 96
          instances; then the unfused block's forward (LayerNorm, two bf16
          cuDNN convolutions, qgelu) at the same shapes, and the shipped
          kernel's launches one by one under ``torch.profiler`` (device ms
          per call, by kernel: prepare, stage Af, stage F).
host      the host's time per call (``--calls`` calls, default 50, after
          warm-up) of K2 at the serving shape on both routes, on weights
          packed once as the served model packs them, and of K3 on the
          same bf16 inputs: the card is held busy first, so the host clock
          times the wrapper and the launches, not the kernels. The served
          request is host-bound when the host's share of it outlasts the
          card's.

Needs the CUDA card and nvcc.
"""

import argparse
import json
import time

import torch

from dist_tpu_torch.ops import _build
from dist_tpu_torch.ops import temporal_net as tn
from dist_tpu_torch.tools import attn_variants, tnet_bwd
from dist_tpu_torch.utils.profiling import time_calls

# (x's shape, F, k): the train step's, the served batch's, then the card
# tests'
TRAIN = ((32, 16, 14, 14, 96), 96, 3)
SERVING = ((8, 16, 14, 14, 96), 96, 3)
SHAPES = (TRAIN, SERVING, ((2, 16, 14, 14, 96), 96, 3),
          ((2, 4, 5, 6, 8), 8, 3), ((1, 5, 3, 7, 40), 24, 5),
          ((3, 2, 14, 14, 128), 128, 1))
NAMES = ("out",)

# K2's bf16 route (bf16 product operands, fp32 sums and elementwise steps,
# the output rounded once) against its plain version (fp32 inside, the
# output rounded to bf16): max |err| / max |ref| and ||err|| / ||ref||, 3
# times the worst reading of seeds 0-2 at :data:`SHAPES` (``errors`` on an
# H100: worst 0.0061 / 0.0028, the train shape 0.0051 / 0.0027). Why:
#   max_rel  both outputs are rounded to bf16, so where the largest
#            outputs lie one step apart is up to 2^-8 of max |out|; the
#            bf16 g and w2 (the 3x3 conv's operands, 2^-9 each over 864-term
#            sums) and xl and w1 move the fp32 sum across such a step
#   rel_l2   the same roundings over every output; they do not shrink with
#            more positions
# The control (w2's (0, 0) tap zeroed in the plain version) reads 0.184 /
# 0.133 or more, 10 and 16 times these limits.
FWD_BF16_LIMITS = {"out": {"max_rel": 0.0183, "rel_l2": 0.0083}}


def inputs(shape, f, k, seed, dtype):
    """x and the block's parameters on the card, seeded, in
    ``chip_smoke.py``'s order and scales."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]

    def rnd(*s, scale=1.0):
        return torch.randn(s, generator=gen, device="cuda") * scale

    x = rnd(*shape).to(dtype)
    params = (1.0 + rnd(c, scale=0.1), rnd(c, scale=0.1),
              rnd(k, 1, 1, c, f, scale=(k * c) ** -0.5), rnd(f, scale=0.1),
              rnd(1, 3, 3, f, c, scale=(9 * f) ** -0.5), rnd(c, scale=0.1))
    return x, params


def errors(got, want):
    """{"out": {"max_rel", "rel_l2"}}: :func:`tnet_bwd.errors` of the
    block's one output."""
    return tnet_bwd.errors((got,), (want,), NAMES)


def instances(p):
    """The names (:func:`tnet_bwd.instance_name`) of K2's bf16 kernels at
    padded width ``p``."""
    return (f"k3_prepare_kernel<{p}, fwd>", f"k3_stage_kernel<{p}, Af>",
            f"k3_stage_kernel<{p}, F>")


def unfused_block(params):
    """The model's unfused TemporalNet (``fused=False``: LayerNorm in fp32,
    two cuDNN ``Conv3d``s in x's dtype, qgelu) holding ``params``, on their
    device. A yardstick only: the port's fused path never calls it."""
    from dist_tpu_torch.models.dist.dist_net import DiSTConfig, TemporalNet

    ln_s, ln_b, w1, b1, w2, b2 = params
    k, c, f = w1.shape[0], w1.shape[-2], w1.shape[-1]
    cfg = DiSTConfig(selected_layers=(0,), temporal_dim=c,
                     temporal_kernel_size=k, temporal_conv_mlp_ratio=f / c)
    mod = TemporalNet(cfg).to(ln_s.device)
    mod.load_state_dict({
        "ln.weight": ln_s, "ln.bias": ln_b,
        "temporal_net.c_fc1.weight": w1.permute(4, 3, 0, 1, 2),
        "temporal_net.c_fc1.bias": b1,
        "temporal_net.c_fc2.weight": w2.permute(4, 3, 0, 1, 2),
        "temporal_net.c_fc2.bias": b2})
    return mod.eval()


def cmd_errors(args):
    worst = {"max_rel": 0.0, "rel_l2": 0.0}
    least = {"max_rel": float("inf"), "rel_l2": float("inf")}
    controls = []
    for shape, f, k in SHAPES:
        for seed in range(args.seeds):
            x, params = inputs(shape, f, k, seed, torch.bfloat16)
            got = tn.fused_temporal_net(x, *params)
            kern = errors(got, tn.temporal_net_plain(x, *params))
            ctrl = errors(got, tn.temporal_net_plain(
                x, *tnet_bwd.control_params(params)))
            for m in worst:
                worst[m] = max(worst[m], kern["out"][m])
                least[m] = min(least[m], ctrl["out"][m])
            controls.append(ctrl)
            print(json.dumps({"shape": list(shape), "f": f, "k": k,
                              "seed": seed, "kernel": kern,
                              "control": ctrl}), flush=True)
    limits = {"out": {m: 3 * v for m, v in worst.items()}}
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "worst": worst,
        "control_least": least, "limits_3x": limits,
        "control_breaks_every_case": all(tnet_bwd.breaches(c, limits)
                                         for c in controls)}), flush=True)


def cmd_variants(args):
    libs = attn_variants.build_all("temporal_net", tnet_bwd.VARIANTS,
                                   tn._SIGNATURES)
    device = torch.cuda.get_device_name(0)
    cases = {}
    for label, (shape, f, k) in (("train", TRAIN), ("serving", SERVING)):
        x, params = inputs(shape, f, k, 0, torch.bfloat16)
        cases[label] = (x, params, tn.pack_weights(*params),
                        tn.fused_temporal_net(x, *params))
    for rnd in range(2):
        for name, lib in libs.items():
            rec = {"variant": name, "round": rnd, "device": device}
            for label, (x, params, packed, want) in cases.items():
                rec[f"{label}_ms"] = time_calls(
                    lambda: tn.launch_fwd(lib, x, packed), "cuda",
                    args.reps)[1]
                if rnd == 0 and name == "shipped":
                    rec[f"{label}_equal_to_the_built_kernel"] = bool(
                        torch.equal(tn.launch_fwd(lib, x, packed), want))
            if rnd == 0:
                usage = _build.parse_ptxas(
                    attn_variants.variant_log(name, "temporal_net"))
                rec["ptxas"] = {
                    tnet_bwd.instance_name(key): [
                        v.get("registers"),
                        v.get("spill_stores", 0) + v.get("spill_loads", 0)]
                    for key, v in usage.items()
                    if tnet_bwd.instance_name(key) in instances(96)}
            print(json.dumps(rec), flush=True)
    with torch.no_grad():
        for label, (x, params, _, _) in cases.items():
            block = unfused_block(params)
            print(json.dumps({
                "variant": "unfused_block", "shape": list(x.shape),
                "device": device,
                "ms": time_calls(lambda: block(x), "cuda", args.reps)[1]}),
                flush=True)
    x, params = cases["train"][:2]
    profile = tnet_bwd.profile_calls(lambda: tn.fused_temporal_net(x, *params))
    print(json.dumps({"profile": profile, "device": device,
                      "shape": list(x.shape)}), flush=True)


def cmd_host(args):
    device = torch.cuda.get_device_name(0)
    (shape, f, k) = SERVING
    for dtype in (torch.bfloat16, torch.float32):
        x, params = inputs(shape, f, k, 0, dtype)
        packed = tn.pack_weights(*params)
        g = torch.ones_like(x)
        calls = {"temporal_net_fwd": lambda: tn.fused_temporal_net(
            x, *params, packed=packed)}
        if dtype == torch.bfloat16:
            calls["temporal_net_bwd"] = lambda: tn.fused_temporal_net_bwd(
                x, g, *params)
        for name, fn in calls.items():
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            # ~0.5 s at the H100's ~2 GHz, longer than the calls' enqueue
            torch.cuda._sleep(1_000_000_000)
            t0 = time.perf_counter()
            for _ in range(args.calls):
                fn()
            host_ms = (time.perf_counter() - t0) * 1e3 / args.calls
            torch.cuda.synchronize()
            print(json.dumps({"kernel": name, "shape": list(shape),
                              "dtype": str(dtype).split(".")[-1],
                              "calls": args.calls,
                              "host_ms_per_call": host_ms,
                              "device": device}), flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("errors")
    p.add_argument("--seeds", type=int, default=3)
    p = sub.add_parser("variants")
    p.add_argument("--reps", type=int, default=20)
    p = sub.add_parser("host")
    p.add_argument("--calls", type=int, default=50)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tnet_fwd: needs the CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    {"errors": cmd_errors, "variants": cmd_variants,
     "host": cmd_host}[args.cmd](args)


if __name__ == "__main__":
    main()
