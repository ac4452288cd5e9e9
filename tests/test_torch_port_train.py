"""The port's train step against the JAX package's, on the CPU, at the tiny
geometry (ViT-Test width 64, 2 layers, T = 4, alpha = 2, temporal dim 16)
with tests/synth_ckpt.py weights carried across by ``state_dict_from_jax``;
plus ``train_epoch``, the NaN guard, the meters and the eval cadence."""

import logging
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.synth_ckpt import add_dist_state_dict, make_clip_state_dict
from dist_tpu.config import load_config as jax_load_config
from dist_tpu.models.base.models import build_model as jax_build_model
from dist_tpu.models.clip.convert import convert_clip_params
from dist_tpu.models.dist.dist_net import DiSTConfig as JaxDiSTConfig
from dist_tpu.optim import losses as jlosses
from dist_tpu.optim import optimizer as jopt
from dist_tpu.tasks import state as jstate
from dist_tpu.utils import meters as jmeters
from dist_tpu.utils import misc as jmisc
from dist_tpu_torch.config import load_config
from dist_tpu_torch.models.base.models import build_model
from dist_tpu_torch.models.clip.convert import state_dict_from_jax, to_torch
from dist_tpu_torch.optim.optimizer import FROZEN, construct_optimizer, param_labels
from dist_tpu_torch.tasks.state import (
    create_train_state,
    ema_decay,
    make_train_step,
)
from dist_tpu_torch.tasks.train import train_epoch
from dist_tpu_torch.utils import meters, misc

TINY = "configs/projects/dist/test/tiny_synth.yaml"
# fp32, mixup off, label smoothing 0.1 (the flagship's), temporal dim 16,
# an EMA copy of the weights
OPTS = ["TRAIN.MIXED_PRECISION", "false", "AUGMENTATION.MIXUP.ENABLE", "false",
        "AUGMENTATION.CUTMIX.ENABLE", "false",
        "VIDEO.BACKBONE.DIST.TEMPORAL_DIM", "16", "MODEL.EMA.ENABLE", "true",
        "MODEL.EMA.DECAY", "0.9"]
STEPS, B = 3, 2
ARCH = dict(embed_dim=32, image_resolution=64, vision_layers=2,
            vision_width=64, vision_patch_size=16, context_length=77,
            vocab_size=49408, transformer_width=64, transformer_layers=2)


def _cfgs(repo_root, opts):
    path = os.path.join(repo_root, TINY)
    return (load_config(path, OPTS + opts, make_output_dir=False),
            jax_load_config(path, OPTS + opts, make_output_dir=False))


def _batches(cfg):
    rng = np.random.default_rng(7)
    n, crop = int(cfg.DATA.NUM_INPUT_FRAMES), int(cfg.DATA.TRAIN_CROP_SIZE)
    classes = int(cfg.VIDEO.HEAD.NUM_CLASSES)
    text = rng.standard_normal((classes, ARCH["embed_dim"])).astype(np.float32)
    return [{"video": rng.integers(0, 256, (B, n, crop, crop, 3),
                                   dtype=np.uint8),
             "labels": rng.integers(0, classes, B).astype(np.int32),
             "text_features": text} for _ in range(STEPS)]


def _run_jax(jcfg, params, batches):
    """The JAX package's jitted train step over ``batches``; the gradient of
    each step from the same loss, for the comparisons."""
    model = jax_build_model(jcfg)
    variables = {"params": params}
    tx, lr_fn = jopt.construct_optimizer(jcfg, variables, 4)
    state = jstate.create_train_state(variables, tx,
                                      float(jcfg.MODEL.EMA.DECAY))
    step = jax.jit(jstate.make_train_step(model, jcfg, tx, lr_fn))

    def loss(v, b):
        inputs = {"video": jstate._prep_video(jcfg, b["video"]),
                  "text_features": b["text_features"]}
        preds, logits = model.apply(v, inputs, train=True)
        return jlosses.calculate_loss(
            jcfg, preds, logits, {"supervised": b["labels"]})[0]

    grad = jax.jit(jax.grad(loss))
    metrics, grads = [], []
    for b in batches:
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        grads.append(state_dict_from_jax(jax.device_get(
            grad(state.variables, jb))["params"]))
        state, m = step(state, jb, jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
        lrs = [float(lr_fn(k)) for k in range(len(batches))]
    return (metrics, grads, state_dict_from_jax(jax.device_get(
        state.variables)["params"]), lrs, state_dict_from_jax(
            jax.device_get(state.ema_variables)["params"]))


def _run_port(cfg, params, batches):
    model = build_model(cfg, device="cpu")
    model.module.load_state_dict(to_torch(state_dict_from_jax(params)))
    start = {k: v.clone() for k, v in model.module.state_dict().items()}
    optimizer, lr_fn = construct_optimizer(cfg, model.module, 4)
    state = create_train_state(model, optimizer, ema_decay(cfg))
    step = make_train_step(model, cfg, optimizer, lr_fn)
    metrics, grads = [], []
    for b in batches:
        tb = {"video": torch.from_numpy(b["video"]),
              "labels": torch.from_numpy(b["labels"]).long(),
              "text_features": torch.from_numpy(b["text_features"])}
        metrics.append({k: float(v) for k, v in step(state, tb).items()})
        grads.append({k: p.grad.clone() for k, p in
                      model.module.named_parameters() if p.requires_grad})
    return metrics, grads, model.module, start, state.ema


@pytest.mark.parametrize("fused", ["true", "false"])
def test_train_step_matches_jax(repo_root, fused):
    """Three steps, fused (K2/K3's plain versions on the CPU) and unfused:
    loss and top-1 error per step; the dist_net gradients of the first
    step, from the same weights (atol 1e-5 of each tensor's largest value:
    fp32, another summation order); the parameters and their EMA after
    three steps; frozen ones bit for bit.

    Adam sends each gradient element to about +-lr * NEW_NET_LRMULT,
    whatever its size, so an element whose gradient is within float noise
    of zero may step either way. The parameters are held to 1e-6 + 1% of
    sum_k lr_k * mult where every step's JAX gradient is at least 1e-3 of
    its tensor's largest; elsewhere to the most AdamW can move an element,
    2 * (1 - beta1) / sqrt(1 - beta2) * sum_k lr_k * mult."""
    cfg, jcfg = _cfgs(repo_root, ["TPU.FUSED_TEMPORAL_NET", fused])
    rng = np.random.default_rng(0)
    sd = make_clip_state_dict(rng, **ARCH)
    jdist = JaxDiSTConfig.from_cfg(jcfg)
    add_dist_state_dict(sd, rng, jdist, d_model=ARCH["vision_width"])
    params, _ = convert_clip_params(sd, with_dist=jdist)
    batches = _batches(cfg)

    jm, jgrads, jparams, lrs, jema = _run_jax(jcfg, params, batches)
    pm, pgrads, module, start, ema = _run_port(cfg, params, batches)

    for k in range(STEPS):
        assert pm[k]["loss"] == pytest.approx(jm[k]["loss"], rel=1e-5)
        assert pm[k]["top1_err"] == jm[k]["top1_err"]
        assert pm[k]["lr"] == pytest.approx(jm[k]["lr"], rel=1e-6)
    assert all(k.startswith("dist_net.") for k in pgrads[0])
    for name, g in pgrads[0].items():
        want = jgrads[0][name]
        np.testing.assert_allclose(
            g.numpy(), want, rtol=0, err_msg=name,
            atol=1e-5 * float(np.abs(want).max()) + 1e-12)

    mult = float(cfg.OPTIMIZER.NEW_NET_LRMULT)
    travel = sum(lrs) * mult
    b1, b2 = cfg.OPTIMIZER.BETAS
    labels = param_labels(cfg, module)
    for name, p in module.named_parameters():
        if labels[name] == FROZEN:
            assert torch.equal(p, start[name]), name
            # the EMA of an unchanged weight: within 1 ulp of the blend
            np.testing.assert_allclose(ema[name].numpy(), jema[name],
                                       rtol=1e-6, atol=1e-7, err_msg=name)
            continue
        steady = np.all([np.abs(g[name]) >= 1e-3 * np.abs(g[name]).max()
                         for g in jgrads], axis=0)
        # the weights, and their EMA, a blend of the weights of every step
        for got, want in ((p.detach().numpy(), jparams[name]),
                          (ema[name].numpy(), jema[name])):
            err = np.abs(got - want)
            assert (err[steady] <= 1e-6 + 0.01 * travel).all(), (
                name, float(err[steady].max()))
            assert (err <= 2 * (1 - b1) / np.sqrt(1 - b2) * travel).all(), name
        assert not torch.equal(p, start[name]) or not (
            np.abs(jparams[name] - start[name].numpy()) > 0).any(), name


def test_train_epoch_logs_through_train_meter(repo_root, caplog):
    """Three synthetic batches on the CPU: the step runs three times, the
    meter logs one line per step (LOG_PERIOD 1) and one for the epoch."""
    cfg, _ = _cfgs(repo_root, ["TPU.FUSED_TEMPORAL_NET", "true"])
    model = build_model(cfg, device="cpu")
    optimizer, lr_fn = construct_optimizer(cfg, model.module, 3)
    state = create_train_state(model, optimizer)
    step = make_train_step(model, cfg, optimizer, lr_fn)
    batches = [{"video": b["video"], "label": b["labels"]}
               for b in _batches(cfg)]
    text = torch.from_numpy(_batches(cfg)[0]["text_features"])
    meter = meters.TrainMeter(len(batches), cfg)
    with caplog.at_level(logging.INFO, logger="dist_tpu_torch"):
        _, preempt_iter = train_epoch(cfg, state, step, batches, meter, 0,
                                      text)
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("json_stats: ")]
    assert state.step == 3 and preempt_iter is None
    assert meter.timing[0]["batches"] == 3
    assert [('"train_iter"' in ln, f'"iter": "{i + 1}/3"' in ln)
            for i, ln in enumerate(lines[:3])] == [(True, True)] * 3
    assert len(lines) == 4 and '"train_epoch"' in lines[3]
    assert meter.num_samples == 0                      # reset after the epoch


def test_nan_loss_stops_the_epoch(repo_root):
    cfg, _ = _cfgs(repo_root, [])
    with pytest.raises(RuntimeError, match="NaN"):
        misc.check_nan_losses(float("nan"))
    misc.check_nan_losses(1.0)

    def nan_step(state, batch):
        z = torch.zeros(())
        return {"loss": z + float("nan"), "top1_err": z, "top5_err": z,
                "lr": z}

    state = types.SimpleNamespace(model=types.SimpleNamespace(
        device=torch.device("cpu")))
    batch = {"video": np.zeros((1, 4, 8, 8, 3), np.uint8), "label": [0]}
    with pytest.raises(RuntimeError, match="NaN"):
        train_epoch(cfg, state, nan_step, [batch, batch],
                    meters.TrainMeter(2, cfg), 0)


def test_train_meter_and_eval_cadence_match_jax(repo_root):
    cfg, jcfg = _cfgs(repo_root, ["TRAIN.NUM_FOLDS", "2", "TRAIN.EVAL_PERIOD",
                                  "4", "OPTIMIZER.MAX_EPOCH", "11"])
    got, want = meters.TrainMeter(5, cfg), jmeters.TrainMeter(5, jcfg)
    rng = np.random.default_rng(8)
    for _ in range(7):
        v = [float(x) for x in rng.random(4)]
        for m in (got, want):
            m.update_stats(v[0] * 100, v[1] * 100, v[2], v[3], 3)
            m.update_custom_stats({"extra": v[0]})
    for attr in ("loss_total", "num_top1_mis", "num_top5_mis", "num_samples",
                 "lr", "max_iter"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.loss.get_win_median() == want.loss.get_win_median()
    assert got.custom["extra"].get_win_avg() == want.custom["extra"].get_win_avg()
    assert [misc.is_eval_epoch(cfg, e) for e in range(12)] == \
        [jmisc.is_eval_epoch(jcfg, e) for e in range(12)]
