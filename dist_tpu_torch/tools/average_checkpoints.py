"""Average model weights across checkpoints of the port (the checkpoint
soup; port of ``tools/average_checkpoints.py``).

    python -m dist_tpu_torch.tools.average_checkpoints \\
        --ckpts out/checkpoints/checkpoint_epoch_00018.pyth \\
                out/checkpoints/checkpoint_epoch_00019.pyth \\
                out/checkpoints/checkpoint_epoch_00020.pyth \\
        --out out/checkpoints/avg_18_20.pyth [--ema]

Inputs are two or more ``.pyth`` checkpoints of the port (a released
reference checkpoint goes through ``convert_checkpoint`` first); the
output is ``{"model_state": ...}``, which loads wherever a trained
checkpoint does (``TEST.CHECKPOINT_FILE_PATH``, the serving engine).
Floating tensors are averaged in float64 and cast back to their dtype;
integer and other tensors take the first checkpoint's value. ``--ema``
averages the EMA weights (``ema``) instead of ``model_state``. The tool
reads and writes files only, so it runs on the host.
"""

import argparse
import sys

import torch

_DIFFERENT_TREES = ("checkpoints carry different parameter trees — are "
                    "they from the same config?")


def average_state_dicts(sds):
    """The mean of state dicts with the same names and shapes: each
    floating tensor's float64 mean cast back to its dtype, every other
    tensor the first's. Raises ``ValueError`` where names or shapes
    differ."""
    first = sds[0]
    for sd in sds[1:]:
        if sd.keys() != first.keys() or any(
                sd[k].shape != v.shape for k, v in first.items()):
            raise ValueError(_DIFFERENT_TREES)
    out = {}
    for k, v in first.items():
        if not v.is_floating_point():
            out[k] = v
            continue
        acc = v.double()
        for sd in sds[1:]:
            acc = acc + sd[k].double()
        out[k] = (acc / len(sds)).to(v.dtype)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m dist_tpu_torch.tools.average_checkpoints",
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ckpts", nargs="+", required=True,
                    help="two or more .pyth checkpoints of the port")
    ap.add_argument("--out", required=True, help="output .pyth file")
    ap.add_argument("--ema", action="store_true",
                    help="average the EMA weights instead of the raw ones")
    args = ap.parse_args(argv)
    if len(args.ckpts) < 2:
        raise ValueError("need at least two checkpoints to average")

    key = "ema" if args.ema else "model_state"
    sds = []
    for path in args.ckpts:
        blob = torch.load(path, map_location="cpu", weights_only=True)
        if key not in blob:
            raise KeyError((path, sorted(blob)))
        sds.append(blob[key])
    torch.save({"model_state": average_state_dicts(sds)}, args.out)
    print(f"averaged {len(sds)} checkpoints ({key}) -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
