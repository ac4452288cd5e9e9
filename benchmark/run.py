"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the traced stretch's busy and window
seconds and a breakdown. Every run checks what its timed path produced
against the reference (``checks.py``) and prints each number beside its
limit. A serving cell also takes ``--sweep r1,r2,...``: one set-up, then
a window at each rate, a line each (the knee is found so; no result).

Exits non-zero, with no result, without enough CUDA cards, or if JAX or
the JAX package was loaded."""

import argparse
import json
import os
import subprocess
import sys
import time

_T_IMPORT = time.perf_counter()

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness, spec  # noqa: E402

CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions"}


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--sweep", default="",
                   help="serving cells: comma-separated rates (requests/s)")
    return p.parse_args(argv)


def _card_line():
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def _launches():
    from dist_tpu_torch.ops import attention, temporal_net

    return {"k1": attention.fused_attention_qkv.launches,
            "k1b": attention.attention_qkv_bwd.launches,
            "k2": temporal_net.fused_temporal_net.launches,
            "k3": temporal_net.fused_temporal_net_bwd.launches}


def _per_layer(run, reported):
    out = {}
    for m in spec.metrics_for(run.cell["name"], reported, run.root):
        value = spec.reader(m["name"], run.root).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _end_to_end(run):
    from benchmark import serve_cell

    w = run.window
    if run.kind == "train":
        values = {"train_clips_per_s": w["clips"] / w["seconds"],
                  "train_peak_gib": w["peak"] / 2 ** 30}
    else:
        values = {"serve_p95_ms": serve_cell.percentile_ms(run, 95)}
    values["setup_s"] = w["setup_s"]
    out = {}
    for m in spec.end_to_end_for(run.cell["name"], run.root):
        if values.get(m["name"]) is not None:
            out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def _sweep(run, rates):
    """One set-up, then a window at each rate: the knee is the highest
    rate whose requests all finish with one batch in service and at most
    one queued at the window's close."""
    from dist_tpu_torch.serving.batcher import MicroBatcher

    from benchmark import serve_cell

    engine, pool = serve_cell.setup(run)
    for rate in rates:
        batcher = MicroBatcher(serve_cell.Predict(engine),
                               max_batch=run.config["serve_batch"],
                               max_delay_ms=run.config["max_delay_ms"])
        try:
            w = serve_cell.window(run, batcher, pool, rate, run.seconds)
        finally:
            batcher.close()
        lat = w["latency_s"]
        ok = [x for x in lat if x is not None]
        close = w["t0"] + w["seconds"]
        by_close = sum(1 for x, d in zip(lat, serve_cell.schedule(
            run, rate, run.seconds)[0]) if x is not None
            and w["t0"] + d + x <= close)
        print(json.dumps({
            "rate": rate, "requests": len(lat), "answered": len(ok),
            # one batch in service and at most one queued at the close
            "sustained": (len(ok) == len(lat)
                          and w["backlog"] <= 2 * run.config["serve_batch"]),
            "answered_by_close": by_close / max(len(lat), 1),
            "backlog_at_close": w["backlog"],
            "p50_ms": 1e3 * float(sorted(ok)[len(ok) // 2]) if ok else None,
            "p95_ms": (1e3 * float(__import__("numpy").percentile(ok, 95))
                       if ok else None),
            "mean_batch": w["batched"] / max(w["batches"], 1),
            "generator_late_ms": 1e3 * w["late_s"]}), flush=True)


def main(argv=None):
    args = _args(argv)
    age = harness.process_age_s()
    t_start = time.perf_counter() - age if age is not None else _T_IMPORT
    cell, config, traffic, limits = spec.cell(args.workload)
    root = spec.ROOT
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(root, ".bench_cache", sub)

    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    run = harness.Run(cell=cell, config=config, traffic=traffic, limits=limits,
                      seed=args.seed, seconds=args.seconds,
                      traced=bool(args.trace), device=device,
                      t_start=t_start, chips=chips)
    print(f"card: {_card_line()}", file=sys.stderr)
    if args.sweep:
        _sweep(run, [float(r) for r in args.sweep.split(",")])
        return _exit_clean()
    return finish(run, *execute(run))


def execute(run):
    """Run the cell; returns (memory peak, numbers, failed requests)."""
    from benchmark import serve_cell, train_cell

    if run.kind == "train":
        peak, numbers = train_cell.run_train(run)
        return peak, numbers, 0
    if run.kind == "serve":
        return serve_cell.run_serve(run)
    raise SystemExit(f"unknown traffic kind {run.kind!r}")


def result(run, peak, numbers, failed):
    """(the result line without its checks, the checks)."""
    from benchmark import checks

    correct, shown = checks.judge(numbers, run.limits)
    correct = correct and failed == 0
    reported = _end_to_end(run)
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": (__import__("torch").cuda.get_device_name(run.device)
                       if run.device.type == "cuda" else "cpu"),
              "count": run.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct),
           "attempted": (run.window.get("steps") if run.kind == "train"
                         else len(run.window.get("latency_s", []))),
           "failed": int(failed)}
    if run.traced:
        out["metrics"] = _per_layer(run, set(reported))
        if run.trace is not None:
            device["busy_s"] = run.trace.busy_s
            device["window_s"] = run.trace.window_s
            out["breakdown"] = {"device_ops": [list(x) for x in run.trace.device_ops],
                                "idle_gaps": run.trace.idle_gaps}
    else:
        out["metrics"] = reported
    out["device"] = device
    return out, shown


def finish(run, peak, numbers, failed):
    out, shown = result(run, peak, numbers, failed)
    print(f"launches: {json.dumps(_launches())}", file=sys.stderr)
    code = _exit_clean()
    if code:
        return code
    harness.emit(out, shown)
    return 0


def _exit_clean():
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded modules the benchmark may not load: {bad}",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
