"""One SSL pretraining train step of the port against the JAX package's,
on the CPU: a HiCo step of the whole S3D-G (its fixed plan at 8 frames
of 32^2) with ``ContrastiveHeadTopicPred`` on 2 videos of 3 views, both
packages in float64 (the JAX package under ``jax.enable_x64``, the
port's module cast), on the same seeded weights and the same normalised
views (so no device augmentation: both packages augment only uint8
video): the loss and its parts (``LOSS_RTOL``), every gradient (each
leaf within ``GRAD_TOL`` of its largest entry; the JAX step's gradients
read off an optax transform that keeps them) and every updated running
stat, backbone and head (each leaf within ``STATS_TOL`` of its largest
entry), the limits set by the JAX package's fp32 roundings (below). The
port's optimizer is LARS, whose step runs after the gradients are
read."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dist_tpu.models.base.models import build_model as jax_build_model
from dist_tpu.tasks import state as jstate
from dist_tpu_torch.models.backbones.convert import state_dict_from_jax
from dist_tpu_torch.models.base import models as pm
from dist_tpu_torch.optim import optimizer as popt
from dist_tpu_torch.tasks import state as pstate
from dist_tpu_torch.tasks.state import _prep_video
from tests.test_torch_port_epic_step import _keep_grads
from tests.test_torch_port_resnet3d import cfgs, jax_variables, load_jax
from tests.test_torch_port_tada import _stats

HICO = "configs/projects/hico/pt-k400/s3dg-hico-l.yaml"
TINY = ["DATA.NUM_INPUT_FRAMES", "8", "DATA.TRAIN_CROP_SIZE", "32",
        "DATA.TEST_CROP_SIZE", "32", "DATA.TEST_SCALE", "32",
        "TRAIN.CHECKPOINT_FILE_PATH", "", "LOG_MODEL_INFO", "false"]
VIDEOS, VIEWS = 2, 3
# float64 on both sides, as the EPIC step (tests/test_torch_port_epic_step.py),
# but the JAX package rounds to fp32 in three places whatever the dtype:
# S3D-G's gates take their means in fp32 (dist_tpu/models/backbones/
# s3dg.py:76), and the heads' L2 norm (dist_tpu/models/heads/
# contrastive.py:40-43) and the TCL loss (dist_tpu/optim/contrastive.py:104)
# are fp32. Read on this step: the loss 1.4e-6 apart (the VCL part
# 3.4e-6), the worst gradient leaf 3.5e-5 of its largest entry
# (Mixed_5c's last 1x1x1 conv); the running stats after the first gate
# 6.5e-7 of their largest entry apart (Mixed_3c's). The limits: 7, 9
# and 15 times these, each leaf's against its largest entry. A
# bias that a BatchNorm follows has a gradient of 0 up to rounding: its
# largest entry below ZERO_GRAD on both sides.
GRAD_TOL = 3e-4
ZERO_GRAD = 1e-6
STATS_TOL = 1e-5
LOSS_RTOL = 1e-5


@pytest.fixture
def few_threads():
    """Two intra-op threads for the port's side: the suite runs in
    several worker processes at once, and S3D-G's CPU convolutions on
    every core in each of them oversubscribe the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_tiny_s3dg_hico_step_matches_jax(repo_root, few_threads):
    clips = np.random.default_rng(130).integers(
        0, 256, (VIDEOS * VIEWS, 8, 32, 32, 3), dtype=np.uint8)
    cfg, jcfg = cfgs(repo_root, HICO, TINY)
    jmodel = jax_build_model(jcfg)
    variables = jax_variables(jmodel, 131, {"video": jnp.zeros(
        clips.shape, jnp.float32)})
    model = pm.build_model(cfg, device="cpu")
    load_jax(model.module, variables)
    video = _prep_video(cfg, torch.from_numpy(clips)).double().numpy()
    batch = {"video": video.reshape((VIDEOS, VIEWS) + video.shape[1:]),
             "labels": np.zeros(VIDEOS, np.int64),
             "contrastive": np.tile(np.arange(VIEWS), (VIDEOS, 1))}
    with jax.enable_x64(True):
        jstep = jax.jit(jstate.make_train_step(jmodel, jcfg, _keep_grads(),
                                               lambda step: 0.1))
        wide = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)
        jnew, want = jstep(jstate.create_train_state(wide, _keep_grads()),
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(0))
        jnew, want = jax.device_get((jnew, want))
    jgrads = state_dict_from_jax(jnew.opt_state, model.module)
    after = state_dict_from_jax(jnew.variables, model.module)

    model.module.double()
    optimizer, lr_fn = popt.construct_optimizer(cfg, model.module, 4)
    assert isinstance(optimizer, popt.LARS)
    grads = {}
    optimizer.register_step_pre_hook(lambda *_: grads.update(
        {k: p.grad.clone() for k, p in model.module.named_parameters()}))
    got = pstate.make_train_step(model, cfg, optimizer, lr_fn)(
        pstate.create_train_state(model, optimizer),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    got = {k: float(v) for k, v in got.items()}
    assert set(got) - {"lr"} == set(want) - {"lr"}
    assert {"vcl_loss_debug", "tcl_loss_debug", "total_loss"} <= set(got)
    for k in want:
        if k != "lr":
            assert got[k] == pytest.approx(float(want[k]), rel=LOSS_RTOL,
                                           abs=1e-12), k
    assert got["top1_err"] == 0.0
    assert len(grads) == len(list(model.module.parameters()))
    for k, g in grads.items():
        w = np.asarray(jgrads[k])
        assert g.dtype == torch.float64 and w.dtype == np.float64, k
        scale = float(np.abs(w).max())
        if scale < ZERO_GRAD:
            assert float(g.abs().max()) < ZERO_GRAD, k
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=k)
    stats = _stats(model.module.state_dict())
    assert any(k.startswith("head.") for k in stats)
    for k, v in stats.items():
        np.testing.assert_allclose(
            v.numpy(), after[k], rtol=0,
            atol=STATS_TOL * float(np.abs(after[k]).max()), err_msg=k)
