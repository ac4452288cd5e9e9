"""The port stands alone: importing every module of ``dist_tpu_torch`` (and
``chip_smoke.py`` as a module) pulls in no JAX, no flax/optax/orbax, no
PyYAML/regex/simplejson, no OpenCV (the card's machine has none) and
nothing of the JAX package; and no source of the port names them in an
import."""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "regex",
             "simplejson", "cv2", "dist_tpu")


def _port_modules():
    import dist_tpu_torch

    names = ["dist_tpu_torch"]
    for info in pkgutil.walk_packages(dist_tpu_torch.__path__,
                                      prefix="dist_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "dist_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name):
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_importing_the_port_loads_nothing_forbidden():
    modules = _port_modules()
    assert len(modules) >= 20, modules
    # torch.distributed is PyTorch: the data-parallel modules count too
    assert {"dist_tpu_torch.parallel.collectives",
            "dist_tpu_torch.parallel.launch",
            "dist_tpu_torch.parallel.mesh"} <= set(modules), modules
    # the Model-Zoo harness and the checkpoint tools
    assert {"dist_tpu_torch.tools.average_checkpoints",
            "dist_tpu_torch.tools.classify",
            "dist_tpu_torch.tools.convert_checkpoint",
            "dist_tpu_torch.tools.reproduce_model_zoo"} <= set(modules), modules
    # the conv family: ResNet3D, the TAda branch, BatchNorm, precision
    assert {"dist_tpu_torch.models.backbones.convert",
            "dist_tpu_torch.models.backbones.resnet3d",
            "dist_tpu_torch.models.base.bn",
            "dist_tpu_torch.models.branches.tada",
            "dist_tpu_torch.models.precision"} <= set(modules), modules
    # SlowFast and S3D-G
    assert {"dist_tpu_torch.models.backbones.slowfast",
            "dist_tpu_torch.models.backbones.s3dg"} <= set(modules), modules
    # SSL pretraining: the views, the heads, the losses, the device
    # augmentation, untrimmed video
    assert {"dist_tpu_torch.ssl.generator",
            "dist_tpu_torch.models.heads.contrastive",
            "dist_tpu_torch.optim.contrastive",
            "dist_tpu_torch.ops.augment_device",
            "dist_tpu_torch.data.long_video"} <= set(modules), modules
    # RandAugment and its OpenCV twins, the submission task, TAL
    assert {"dist_tpu_torch.data.rand_augment",
            "dist_tpu_torch.tasks.submission",
            "dist_tpu_torch.models.backbones.localization",
            "dist_tpu_torch.models.heads.bmn",
            "dist_tpu_torch.optim.localization",
            "dist_tpu_torch.tal.bboxes_1d",
            "dist_tpu_torch.tal.eval",
            "dist_tpu_torch.tal.tools"} <= set(modules), modules
    code = (
        "import importlib, importlib.util, json, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "spec = importlib.util.spec_from_file_location(\n"
        f"    'chip_smoke', {os.path.join(REPO, 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_nothing_forbidden(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    bad = [n for n in names if _forbidden(n)]
    assert not bad, bad
