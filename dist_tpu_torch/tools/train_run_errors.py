"""How far two uninterrupted runs of the same train run lie from each
other: the readings behind ``chip_smoke.py``'s ``TRAIN_RUN_RESUME_LIMIT``,
the limit on a resumed run's weights against an uninterrupted one's.

    python -m dist_tpu_torch.tools.train_run_errors [--device cpu] [--repeats N]
        [--cfg <yaml>] [KEY VALUE ...]

Each repeat runs the train entry of ``python -m dist_tpu_torch.run``
twice in fresh output directories, on ``--cfg`` (default: the flagship)
with ``TRAIN_RUN_OPTS`` (the ``train_run`` phase's settings: synthetic
clips, 2 fold-epochs of 4 steps at batch 32, mixup and cutmix on, EMA on,
K2 and K3 fused) and the test entries off, on ``--device`` (default: the
CUDA card). One JSON line per repeat: the largest absolute difference of
the two runs' dist_net weights; then the worst of them. 0 means the
path is deterministic.
"""

import argparse
import json
import os
import tempfile

import torch

from dist_tpu_torch import run
from dist_tpu_torch.config import load_from_args

FLAGSHIP = "configs/projects/dist/ssv2/vit-b16-8+16f.yaml"
# the flagship's run list with training first, on synthetic clips: 32
# clips at batch 32 with NUM_FOLDS 4 give 4 steps a fold-epoch, MAX_EPOCH 8
# two fold-epochs, each checkpointed and evaluated (the plain weights,
# then the EMA's); then the test run list on 16 clips
TRAIN_RUN_OPTS = ["DATA.SYNTHETIC", "true", "TPU.FUSED_TEMPORAL_NET", "true",
                  "TRAIN.ENABLE", "true", "TRAIN.NUM_SAMPLES_LIMIT", "32",
                  "OPTIMIZER.MAX_EPOCH", "8", "TRAIN.EVAL_PERIOD", "4",
                  "TRAIN.CHECKPOINT_PERIOD", "4",
                  "TRAIN.CHECKPOINT_KEEP_LAST", "2", "MODEL.EMA.ENABLE",
                  "true", "TRAIN.AUTO_RESUME", "true", "TEST.ENABLE", "true",
                  "TEST.NUM_SAMPLES_LIMIT", "16", "LOG_CONFIG_INFO", "false"]


def dist_net_weights(state):
    """The dist_net parameters of a ``TrainState``, on the host."""
    return {k: p.detach().cpu() for k, p in
            state.model.module.named_parameters() if k.startswith("dist_net.")}


def max_abs_diff(a, b):
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)


def train_once(argv, out):
    """The final state of the run list's train entry, in ``out``."""
    cfg = load_from_args(argv + ["OUTPUT_DIR", out, "TEST.ENABLE", "false"])
    (run_cfg, train), = run._prepare_data(cfg)
    return train(run_cfg, device=cfg.args.device)


def readings(argv, repeats):
    out = []
    for i in range(repeats):
        with tempfile.TemporaryDirectory() as tmp:
            states = [train_once(argv, os.path.join(tmp, str(k)))
                      for k in range(2)]
            out.append({"repeat": i, "steps": [int(s.step) for s in states],
                        "max_abs_diff": max_abs_diff(
                            *(dist_net_weights(s) for s in states))})
            del states
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card; 'cpu' for the CPU")
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--cfg", default=FLAGSHIP)
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    run_argv = ["--cfg", args.cfg] + (["--device", args.device]
                                      if args.device else [])
    run_argv += TRAIN_RUN_OPTS + args.opts
    recs = readings(run_argv, args.repeats)
    device = (torch.cuda.get_device_name(0) if args.device is None
              else args.device)
    for rec in recs:
        print(json.dumps({"device": device, **rec}), flush=True)
    print(json.dumps({"device": device, "worst_max_abs_diff": max(
        r["max_abs_diff"] for r in recs)}), flush=True)


if __name__ == "__main__":
    main()
