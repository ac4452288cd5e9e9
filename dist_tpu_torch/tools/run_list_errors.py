"""How far the tiny test run list in bf16 lies from the same run list in
fp32 on the CPU, the readings behind ``RUN_LIST_BF16_LIMIT``
(``tests/test_torch_port_cuda.py``).

    python -m dist_tpu_torch.tools.run_list_errors [--device cpu] [--seeds N]

For weight seeds 0 .. N-1 (default 3): the port's model for
``configs/projects/dist/test/tiny_synth.yaml`` made from the seed and saved
as a ``.pyth``; the run list of ``python -m dist_tpu_torch.run`` (test,
then the automatic 3-view test) on it in fp32 on the CPU, and in bf16 with
the fused TemporalNet on ``--device`` (default: the CUDA card). One JSON
line per seed and entry: the largest difference of a video's ensembled
score, divided by the entry's views (``max_abs_diff_per_view``); then the
worst of them.
"""

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from dist_tpu_torch import run
from dist_tpu_torch.config import load_config
from dist_tpu_torch.models.base.models import build_model

TINY = "configs/projects/dist/test/tiny_synth.yaml"


def readings(device, seeds, repo):
    path = os.path.join(repo, TINY)
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for seed in range(seeds):
            ckpt = os.path.join(tmp, f"seed{seed}.pyth")
            opts = ["TRAIN.ENABLE", "false", "TPU.FUSED_TEMPORAL_NET", "true",
                    "OUTPUT_DIR", tmp, "TEST.CHECKPOINT_FILE_PATH", ckpt]
            cfg = load_config(path, opts, make_output_dir=False)
            torch.save(build_model(cfg, device="cpu", seed=seed)
                       .module.state_dict(), ckpt)
            fp32 = run.main(["--cfg", path, "--device", "cpu", *opts,
                             "TRAIN.MIXED_PRECISION", "false"])
            argv = ["--cfg", path, *opts, "TRAIN.MIXED_PRECISION", "true"]
            bf16 = run.main((["--device", device] if device else []) + argv)
            for want, got in zip(fp32, bf16):
                err = np.abs(got.video_preds - want.video_preds).max()
                out.append({"seed": seed, "views": got.num_clips,
                            "max_abs_diff_per_view": float(err)
                            / got.num_clips})
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="where the bf16 run list runs (default: the "
                             "CUDA card)")
    parser.add_argument("--seeds", type=int, default=3)
    args = parser.parse_args(argv)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    device = (torch.cuda.get_device_name(0) if args.device is None
              else args.device)
    recs = readings(args.device, args.seeds, repo)
    for rec in recs:
        print(json.dumps({"device": device, **rec}), flush=True)
    print(json.dumps({"device": device, "worst_per_view": max(
        r["max_abs_diff_per_view"] for r in recs)}), flush=True)


if __name__ == "__main__":
    main()
