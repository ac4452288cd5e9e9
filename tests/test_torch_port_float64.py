"""The conv family's train step in float64 on the CPU: the fp32 islands
(BatchNorm, the heads' pooling and activations, TAda's route function,
S3D-G's gate, the losses) compute in float64 for a float64 input, so that
a step of a model cast to float64 rounds nowhere to fp32. The card
against the CPU is held on such a step (``chip_smoke.py``'s train
agreements, ``tests/test_torch_port_cuda.py``); this file holds the
property itself:

- ``island_dtype``: fp32 for bf16, fp16 and fp32, float64 for float64;
- for a tiny TAda2D, SlowFast (dual heads), ir-CSN (dual heads) and
  S3D-G: no operation that autograd records in the float64 step yields a
  tensor narrower than float64 (the step's error counts, taken without
  gradients, may), every gradient and running stat is float64, and the
  loss lies within ``LOSS_RTOL`` of the fp32 step's."""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dist_tpu_torch.config import load_config
from dist_tpu_torch.models.base.models import build_model
from dist_tpu_torch.models.precision import island_dtype
from dist_tpu_torch.optim.optimizer import construct_optimizer
from dist_tpu_torch.tasks.state import (
    _prep_video,
    create_train_state,
    make_train_step,
)
from tests.test_torch_port_cuda import CONV_TINY, TADA_TINY_OPTS

MODELS = {**CONV_TINY,
          "tada": ("configs/projects/tada/k400/tada2d_8x8.yaml",
                   TADA_TINY_OPTS, 2)}
# the fp32 step against the float64 one: fp32 rounding of a tiny net
LOSS_RTOL = 1e-4


@pytest.mark.parametrize("dtype,want", [
    (torch.bfloat16, torch.float32), (torch.float16, torch.float32),
    (torch.float32, torch.float32), (torch.float64, torch.float64)])
def test_island_dtype(dtype, want):
    assert island_dtype(torch.zeros(1, dtype=dtype)) == want


class _Narrow(TorchDispatchMode):
    """Records each operation that runs with gradients enabled and yields
    a floating tensor narrower than float64."""

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.is_grad_enabled():
            outs = out if isinstance(out, (tuple, list)) else [out]
            if any(isinstance(o, torch.Tensor) and o.is_floating_point()
                   and o.dtype != torch.float64 for o in outs):
                self.ops.add(str(func))
        return out


def _step(repo_root, name, dtype, probe=None):
    path, opts, n = MODELS[name]
    cfg = load_config(f"{repo_root}/{path}", opts, make_output_dir=False)
    t, s = int(cfg.DATA.NUM_INPUT_FRAMES), int(cfg.DATA.TRAIN_CROP_SIZE)
    gen = torch.Generator().manual_seed(3)
    clips = torch.randint(0, 256, (n, t, s, s, 3), generator=gen,
                          dtype=torch.int32).to(torch.uint8)
    batch = {"video": _prep_video(cfg, clips).to(dtype),
             "labels": torch.arange(n) % 5}
    if name in ("slowfast", "csn"):
        batch.update(label_verb=torch.arange(n) % 5,
                     label_noun=(torch.arange(n) + 3) % 7)
    model = build_model(cfg, device="cpu", seed=0)
    model.module.to(dtype)
    optimizer, lr_fn = construct_optimizer(cfg, model.module, 4)
    step = make_train_step(model, cfg, optimizer, lr_fn)
    state = create_train_state(model, optimizer)
    if probe is None:
        metrics = step(state, batch)
    else:
        with probe:
            metrics = step(state, batch)
    return float(metrics["loss"]), model.module


@pytest.mark.parametrize("name", list(MODELS))
def test_float64_step_rounds_nowhere_to_fp32(repo_root, name):
    probe = _Narrow()
    loss, module = _step(repo_root, name, torch.float64, probe)
    assert not probe.ops, probe.ops
    assert all(p.grad.dtype == torch.float64 for p in module.parameters())
    assert all(v.dtype == torch.float64 for v in module.state_dict().values()
               if v.is_floating_point())
    loss32, _ = _step(repo_root, name, torch.float32)
    assert loss == pytest.approx(loss32, rel=LOSS_RTOL)
