"""Convert a released reference checkpoint into a checkpoint of the port
(port of ``tools/convert_checkpoint.py``).

    python -m dist_tpu_torch.tools.convert_checkpoint \\
        --cfg configs/projects/dist/ssv2/vit-b16-8+16f.yaml \\
        --src weights/DIST_VIT_B16.pyth --dst output/converted.pyth

Reads ``--src`` (a training checkpoint's ``model_state`` or
``state_dict``, a plain state dict, or OpenAI's TorchScript archive) with
``models/clip/convert.py::load_torch_state_dict``, which strips a
``module.`` prefix and renames ``ladder_net.`` to ``dist_net.``. Prints
the CLIP architecture sniffed from its shapes, keeps the tensors whose
names and shapes match the model that ``--cfg`` builds (as the test
task's load takes them), prints what did not match and the parameter
count, and writes ``{"epoch": 0, "step": 0, "model_state": ...}`` to
``--dst`` with ``torch.save``: point ``TEST.CHECKPOINT_FILE_PATH`` (or
``TRAIN.CHECKPOINT_FILE_PATH``, to fine-tune) at it.

The JAX package's tool writes an Orbax checkpoint; the port reads none
(``utils/checkpoint.py`` says how a JAX TrainState comes across). The
tool reads and writes files only, so it runs on the host.
"""

import argparse
import os
import sys

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m dist_tpu_torch.tools.convert_checkpoint",
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--src", required=True,
                    help="released torch .pyth/.pt checkpoint")
    ap.add_argument("--dst", required=True, help="output .pyth file")
    args = ap.parse_args(argv)

    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.models.base.models import build_backbone_on_meta
    from dist_tpu_torch.models.clip.convert import load_torch_state_dict
    from dist_tpu_torch.models.clip.model import sniff_architecture
    from dist_tpu_torch.utils.checkpoint import match_state_dict

    cfg = load_config(args.cfg, make_output_dir=False)
    sd = load_torch_state_dict(args.src)
    print(f"Sniffed architecture: {sniff_architecture(sd)}")
    sd, missing, unexpected = match_state_dict(
        sd, build_backbone_on_meta(cfg).state_dict())
    if missing:
        print(f"Keys in model not matched ({len(missing)}): {missing[:20]}")
    if unexpected:
        print(f"Keys in checkpoint not matched ({len(unexpected)}): "
              f"{unexpected[:20]}")
    print(f"Converted {sum(v.numel() for v in sd.values()):,} parameters")
    os.makedirs(os.path.dirname(os.path.abspath(args.dst)), exist_ok=True)
    torch.save({"epoch": 0, "step": 0, "model_state": sd}, args.dst)
    print(f"Saved checkpoint at {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
