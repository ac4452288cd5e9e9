"""One-command Model-Zoo acceptance harness of the port (port of
``tools/reproduce_model_zoo.py``).

Runs the reference's published eval protocol (multi-view score-sum
ensemble, the automatic multi-view view policy) through the port's test
task for each Model-Zoo config, and holds acc@1 within ``--tolerance``
(default 0.3) of the published number.

    python -m dist_tpu_torch.tools.reproduce_model_zoo \\
        --ckpt-dir /weights \\
        --ssv2-root /data/ssv2/videos --ssv2-anno /data/ssv2/annos \\
        --k400-root /data/k400 --k400-anno /data/k400/annos \\
        [--configs ssv2/vit-b16-8+16f ...] [--tolerance 0.3] [--device cpu]

Checkpoints are looked up in ``--ckpt-dir`` by config stem
(``<stem>.pyth``/``.pt``/``.pth``), or given with repeated ``--ckpt
<stem>=<path>``. Released ``.pyth`` checkpoints (the old ``ladder_net.*``
names too) load as they are. The port reads no Orbax checkpoint: an
Orbax directory named after the stem is reported, with how to convert
it, and not taken.

``--dry-run`` runs the whole harness on synthetic clips and random
weights at each config's own geometry (views capped at 2, one crop; no
accuracy check). ``--strict`` is acceptance: it refuses ``--dry-run``,
checks every selected row for its dataset root, annotation directory
and checkpoint, and exits 2 listing everything missing before it
evaluates anything. Until a strict run passes, the Model-Zoo accuracy
is unproven: a green dry run proves the harness, never the numbers.

Prints one JSON line per model and a summary; exits 1 if any model
misses the tolerance. Runs on the CUDA card; ``--device cpu`` runs on
the CPU.
"""

import argparse
import json
import os
import sys

from dist_tpu_torch.utils.checkpoint import _ORBAX_TODO

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# (config path, dataset family, published acc@1, acc@5): the reference's
# Model-Zoo table
ZOO = [
    ("configs/projects/dist/ssv2/vit-b16-8+16f.yaml", "ssv2", 68.7, 91.1),
    ("configs/projects/dist/ssv2/vit-b16-16+32f.yaml", "ssv2", 70.2, 92.0),
    ("configs/projects/dist/ssv2/vit-b16-32+64f.yaml", "ssv2", 70.9, 92.1),
    ("configs/projects/dist/ssv2/vit-l14-32+64f.yaml", "ssv2", 73.1, 93.2),
    ("configs/projects/dist/k400/vit-b16-8+16f.yaml", "k400", 83.6, 96.3),
    ("configs/projects/dist/k400/vit-b16-16+32f.yaml", "k400", 84.4, 96.7),
    ("configs/projects/dist/k400/vit-b16-32+64f.yaml", "k400", 85.0, 97.0),
    ("configs/projects/dist/k400/vit-l14-32+64f.yaml", "k400", 88.0, 97.9),
]


def _stem(config_path):
    ds = os.path.basename(os.path.dirname(config_path))
    return f"{ds}_{os.path.splitext(os.path.basename(config_path))[0]}"


def _find_ckpt(args, config_path):
    stem = _stem(config_path)
    if stem in args.ckpt_map:
        return args.ckpt_map[stem]
    if args.ckpt_dir:
        for suffix in (".pyth", ".pt", ".pth"):
            p = os.path.join(args.ckpt_dir, stem + suffix)
            if os.path.exists(p):
                return p
    return None


def _orbax_dir(args, config_path):
    """The Orbax directory named after the row's stem in ``--ckpt-dir``,
    or None."""
    if not args.ckpt_dir:
        return None
    p = os.path.join(args.ckpt_dir, _stem(config_path))
    return p if os.path.isdir(p) else None


def _no_ckpt(args, config_path):
    """Why a row has no checkpoint."""
    stem = _stem(config_path)
    orbax = _orbax_dir(args, config_path)
    if orbax:
        return f"{config_path}: {orbax}: {_ORBAX_TODO}"
    return (f"{config_path}: no checkpoint named {stem}[.pyth/.pt/.pth] "
            "under --ckpt-dir, and no --ckpt override")


def _apply_view_policy(cfg):
    """The automatic multi-view policy (``run.py::_prepare_data``)."""
    ds = str(cfg.TEST.DATASET)
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 10
    cfg.TEST.NUM_SPATIAL_CROPS = 3 if ("kinetics" in ds or "epickitchen" in ds) else 1
    if "ssv2" in ds:
        cfg.TEST.NUM_ENSEMBLE_VIEWS = 3
        cfg.TEST.NUM_SPATIAL_CROPS = 1
    if cfg.TEST.OVERRIDE_MULTI_SCALE_TEST.ENABLE:
        cfg.TEST.NUM_ENSEMBLE_VIEWS = (
            cfg.TEST.OVERRIDE_MULTI_SCALE_TEST.NUM_ENSEMBLE_VIEWS)
        cfg.TEST.NUM_SPATIAL_CROPS = (
            cfg.TEST.OVERRIDE_MULTI_SCALE_TEST.NUM_SPATIAL_CROPS)


def _preflight_strict(args, rows):
    """Every selected row must have real data and a real checkpoint on
    disk. Returns the list of human-readable gaps (empty: ready)."""
    missing = []
    for config_path, family, _, _ in rows:
        root = getattr(args, f"{family}_root")
        anno = getattr(args, f"{family}_anno")
        if not root:
            missing.append(f"{config_path}: --{family}-root not given")
        elif not os.path.isdir(root):
            missing.append(f"{config_path}: --{family}-root {root} does not exist")
        if not anno:
            missing.append(f"{config_path}: --{family}-anno not given")
        elif not os.path.isdir(anno):
            missing.append(f"{config_path}: --{family}-anno {anno} does not exist")
        ckpt = _find_ckpt(args, config_path)
        if not ckpt:
            missing.append(_no_ckpt(args, config_path))
        elif not os.path.exists(ckpt):
            missing.append(f"{config_path}: checkpoint {ckpt} does not exist")
    return missing


def row_config(args, config_path, family):
    """The Config that a row evaluates: the view policy applied, and in a
    dry run synthetic clips, batch 1 and at most 2 views of one crop."""
    from dist_tpu_torch.config import load_config

    opts = ["TRAIN.ENABLE", "false", "TEST.ENABLE", "true",
            "LOG_MODEL_INFO", "false", "LOG_CONFIG_INFO", "false",
            "OUTPUT_DIR", os.path.join(args.output_dir, _stem(config_path))]
    if args.dry_run:
        opts += ["DATA.SYNTHETIC", "true", "TEST.NUM_SAMPLES_LIMIT",
                 str(args.dry_run_samples), "DATA_LOADER.NUM_WORKERS", "0",
                 "TEST.BATCH_SIZE", "1"]
    else:
        root = getattr(args, f"{family}_root")
        anno = getattr(args, f"{family}_anno")
        if not (root and anno):
            raise ValueError(
                f"--{family}-root/--{family}-anno required for {config_path}")
        opts += ["DATA.DATA_ROOT_DIR", root, "DATA.ANNO_DIR", anno]
        ckpt = _find_ckpt(args, config_path)
        if not ckpt:
            raise FileNotFoundError(
                f"{_no_ckpt(args, config_path)}: pass --ckpt "
                f"{_stem(config_path)}=<path> or put it in --ckpt-dir")
        opts += ["TEST.CHECKPOINT_FILE_PATH", ckpt]
    opts += args.opts

    cfg = load_config(os.path.join(REPO, config_path), opts=opts)
    _apply_view_policy(cfg)
    if args.dry_run:
        # keep dry-run shapes small; the policy's view count still applies
        cfg.TEST.NUM_ENSEMBLE_VIEWS = min(cfg.TEST.NUM_ENSEMBLE_VIEWS, 2)
        cfg.TEST.NUM_SPATIAL_CROPS = 1
    return cfg


def run_one(args, config_path, family, acc1, acc5):
    """Evaluate one row and print its JSON line; returns (the line, the
    test meter)."""
    from dist_tpu_torch.tasks.test import test

    cfg = row_config(args, config_path, family)
    meter = test(cfg, device=args.device)
    got1 = float(meter.stats["top1_acc"])
    got5 = float(meter.stats.get("top5_acc", float("nan")))
    ok = args.dry_run or abs(got1 - acc1) <= args.tolerance
    row = {
        "config": config_path,
        "views": f"{cfg.TEST.NUM_ENSEMBLE_VIEWS}x{cfg.TEST.NUM_SPATIAL_CROPS}",
        "top1_acc": round(got1, 2), "top5_acc": round(got5, 2),
        "expected_top1": acc1, "expected_top5": acc5,
        "delta_top1": round(got1 - acc1, 2),
        "pass": bool(ok), "dry_run": bool(args.dry_run),
    }
    print(json.dumps(row), flush=True)
    return row, meter


def main(argv=None):
    """Run the harness; returns the exit code (0 all pass, 1 a miss, 2 a
    strict run refused)."""
    ap = argparse.ArgumentParser(
        prog="python -m dist_tpu_torch.tools.reproduce_model_zoo",
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt", action="append", default=[],
                    help="<config-stem>=<path>, e.g. "
                         "ssv2_vit-b16-8+16f=/w/dist_b16_ssv2.pyth")
    ap.add_argument("--ssv2-root", default=None)
    ap.add_argument("--ssv2-anno", default=None)
    ap.add_argument("--k400-root", default=None)
    ap.add_argument("--k400-anno", default=None)
    ap.add_argument("--configs", nargs="*", default=None,
                    help="substring filters, e.g. ssv2/vit-b16-8+16f")
    ap.add_argument("--tolerance", type=float, default=0.3)
    ap.add_argument("--output-dir", default="output/model_zoo_repro")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    ap.add_argument("--dry-run", action="store_true",
                    help="synthetic data + random weights; checks the "
                         "harness end to end, skips the accuracy check")
    ap.add_argument("--strict", action="store_true",
                    help="acceptance mode: refuse --dry-run and exit 2 "
                         "listing every missing dataset/checkpoint before "
                         "evaluating; a strict pass is the only run that "
                         "proves the Model-Zoo numbers")
    ap.add_argument("--dry-run-samples", type=int, default=4)
    ap.add_argument("--opts", nargs=argparse.REMAINDER, default=[],
                    help="trailing dotted-key overrides applied to every "
                         "config (e.g. --opts DATA.TEST_CROP_SIZE 96)")
    args = ap.parse_args(argv)
    args.ckpt_map = dict(kv.split("=", 1) for kv in args.ckpt)
    rows = [r for r in ZOO
            if not args.configs or any(f in r[0] for f in args.configs)]
    if not rows:
        raise ValueError(f"no zoo entry matches {args.configs}")
    if args.strict:
        if args.dry_run:
            print(json.dumps({"summary": "model_zoo_repro", "error":
                              "--strict forbids --dry-run: a dry run proves "
                              "the harness, not the numbers"}), flush=True)
            return 2
        missing = _preflight_strict(args, rows)
        if missing:
            for m in missing:
                print(json.dumps({"missing": m}), flush=True)
            print(json.dumps({"summary": "model_zoo_repro", "strict": True,
                              "models": len(rows), "missing": len(missing),
                              "error": "acceptance inputs absent — the "
                                       "Model-Zoo numbers remain UNPROVEN"}),
                  flush=True)
            return 2
    failures = 0
    for row in rows:
        line, _ = run_one(args, *row)
        failures += not line["pass"]
    print(json.dumps({"summary": "model_zoo_repro", "models": len(rows),
                      "failures": failures, "tolerance": args.tolerance,
                      "proof": not args.dry_run}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
