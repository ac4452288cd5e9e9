"""The port's TAda branch and the whole TAda2D against the JAX package's
on the CPU, on seeded JAX weights (``tests/test_torch_port_resnet3d.py``
draws them; the zero inits and the running stats drawn too, so that
``alpha`` is away from 1 and the avg-pool branch counts):

- ``RouteFuncMLP``, ``TAdaConv2d`` and ``TAdaConvBlockAvgPool`` in eval
  and in train mode: outputs at ``atol=2e-4, rtol=1e-4``, and the
  updated running mean and variance against JAX's
  ``mutable=["batch_stats"]`` at ``rtol=1e-5, atol=1e-6`` (flax's running
  variance is the biased one, torch's BatchNorm the unbiased one);
- a tiny TAda2D (DEPTH 18, NUM_FILTERS [8, 16, 32, 64, 128], 4 frames of
  32^2, batch 2) whole with ``BaseHead``: eval in fp32 (scores at
  ``atol=2e-4, rtol=1e-4``, pooled features at ``FEAT_TOL``) and under
  ``TRAIN.MIXED_PRECISION`` (bf16 convs: the limits are in the tests,
  with the route function and the TAda block in bf16 alone), and a
  training forward under ``BN.FREEZE`` (running stats read, not moved);
- one SGD-Nesterov train step against the JAX ``make_train_step`` (mixup
  off, dropout 0): the loss, every updated weight and running stat;
- the eval step after a train step runs in eval mode: its preds are a
  fresh eval-mode forward's, and it leaves the running stats alone."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dist_tpu.models.backbones import resnet3d as jr
from dist_tpu.models.base.bn import set_bn_frozen
from dist_tpu.models.base.models import build_model as jax_build_model
from dist_tpu.models.branches import tada as jt
from dist_tpu.optim import optimizer as jopt
from dist_tpu.tasks import state as jstate
from dist_tpu_torch.models.backbones import resnet3d as pr
from dist_tpu_torch.models.backbones.convert import jax_table, state_dict_from_jax
from dist_tpu_torch.models.base.bn import BatchNorm
from dist_tpu_torch.models.base.models import build_model
from dist_tpu_torch.models.branches import tada as pt
from dist_tpu_torch.optim.optimizer import construct_optimizer
from dist_tpu_torch.tasks.state import (
    create_train_state,
    make_eval_step,
    make_train_step,
)
from tests.test_torch_port_resnet3d import (
    TOL,
    cfgs,
    from_ncdhw,
    jax_variables,
    load_jax,
    port_module,
    to_ncdhw,
)

TADA = "configs/projects/tada/k400/tada2d_8x8.yaml"
TINY = ["VIDEO.BACKBONE.DEPTH", "18",
        "VIDEO.BACKBONE.NUM_FILTERS", "[8, 16, 32, 64, 128]",
        "DATA.NUM_INPUT_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32",
        "VIDEO.HEAD.NUM_CLASSES", "7", "VIDEO.HEAD.DROPOUT_RATE", "0.0",
        "OPTIMIZER.WARMUP_EPOCHS", "0", "LOG_MODEL_INFO", "false"]
STATS_TOL = dict(rtol=1e-5, atol=1e-6)
# the running stats after a whole step: deep layers' statistics carry the
# rounding of the layers before them (1.7e-5 relative on this host)
STEP_STATS_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16 limits (module: 3 times this host's reading; whole model: see its
# test)
BF16_REL = 1e-2
BF16_WHOLE_RATIO = 1.5
# the pooled features before the head, fp32: 4.5e-4 of 2.75 on this host
FEAT_TOL = dict(atol=1e-3, rtol=1e-3)


def _stats(sd):
    return {k: v for k, v in sd.items()
            if k.endswith("running_mean") or k.endswith("running_var")}


def _assert_stats(module, variables, new_stats):
    want = _stats(state_dict_from_jax({**variables, **new_stats}, module))
    got = _stats(module.state_dict())
    assert want and set(want) == set(got)
    before = _stats(state_dict_from_jax(variables, module))
    for k in want:
        assert not np.allclose(want[k], before[k]), k   # the stats moved
        np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=k,
                                   **STATS_TOL)


def _branch_cfg(repo_root):
    return cfgs(repo_root, "configs/pool/backbone/tada2d.yaml",
                TINY[:4] + ["VIDEO.BACKBONE.BRANCH.NAME",
                            "TAdaConvBlockAvgPool"])


def _modules(repo_root):
    """(name, JAX module, port module, JAX call args (NDHWC), port args)."""
    cfg, jcfg = _branch_cfg(repo_root)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 8, 8, 16)).astype(np.float32)
    alpha = rng.uniform(0.5, 1.5, (2, 4, 1, 1, 16)).astype(np.float32)
    spec = jr.block_shapes(jcfg, 2, 0)
    return [
        ("RouteFuncMLP", jt.RouteFuncMLP(16, 4, (3, 3)),
         port_module(pt.RouteFuncMLP, 16, 4, (3, 3)), (x,)),
        ("TAdaConv2d", jt.TAdaConv2d(8, (3, 3), (2, 2)),
         port_module(pt.TAdaConv2d, 16, 8, (3, 3), (2, 2)), (x, alpha)),
        ("TAdaConvBlockAvgPool", jt.TAdaConvBlockAvgPool(spec),
         port_module(pt.TAdaConvBlockAvgPool, pr.block_shapes(cfg, 2, 0)),
         (x,)),
    ]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("index", [0, 1, 2], ids=[
    "RouteFuncMLP", "TAdaConv2d", "TAdaConvBlockAvgPool"])
def test_tada_modules_match_jax(repo_root, index, train):
    set_bn_frozen(False)
    name, jmod, mod, args = _modules(repo_root)[index]
    jargs = [jnp.asarray(a) for a in args]
    variables = jax_variables(jmod, 11 + index, *jargs)
    kwargs = {} if name == "TAdaConv2d" else {"train": train}
    if train and name != "TAdaConv2d":
        want, new_stats = jmod.apply(variables, *jargs, mutable=["batch_stats"],
                                     **kwargs)
    else:
        want, new_stats = jmod.apply(variables, *jargs, **kwargs), None
    load_jax(mod, variables).train(train)
    with torch.no_grad():
        got = mod(*(to_ncdhw(a) for a in args))
    np.testing.assert_allclose(from_ncdhw(got), np.asarray(want), **TOL)
    if name == "RouteFuncMLP":
        # the calibration is away from 1 where it is checked
        assert float(np.abs(np.asarray(want) - 1).mean()) > 0.1
    if new_stats is not None:
        _assert_stats(mod, variables, new_stats)
    elif name != "TAdaConv2d":   # eval: the running stats are left alone
        before = _stats(state_dict_from_jax(variables, mod))
        for k, v in _stats(mod.state_dict()).items():
            np.testing.assert_array_equal(v.numpy(), before[k])


def _calibrate(module, video, variables, rng, jitter=True):
    """Running stats near the data's, written into the JAX ``variables``
    and loaded into ``module``: in one eval-mode forward, each BatchNorm
    (in the order they run) takes its input's per-channel mean, moved by
    N(0, 0.1) standard deviations, and variance, scaled by [0.7, 1.4), so
    that a deep eval-mode forward stays in range and differs from a
    training one."""
    table = jax_table(module)
    names = {m: n for n, m in module.named_modules()}

    def pre_hook(bn, args):
        x = args[0].detach().float()
        dims = [0] + list(range(2, x.dim()))
        var, mean = torch.var_mean(x, dim=dims, correction=0)
        var = var.clamp_min(0.1 * float(var.mean()))
        if jitter:
            mean = mean + torch.from_numpy(
                rng.normal(0, 0.1, var.shape).astype(np.float32)) * var.sqrt()
            var = var * torch.from_numpy(
                rng.uniform(0.7, 1.4, var.shape).astype(np.float32))
        for stat, value in (("running_mean", mean), ("running_var", var)):
            getattr(bn, stat).copy_(value)
            leaf = table[f"{names[bn]}.{stat}"]
            node = variables[leaf.collection]
            *parents, last = leaf.path.split("/")
            for seg in parents:
                node = node[seg]
            node[last] = value.numpy().copy()

    hooks = [m.register_forward_pre_hook(pre_hook) for m in module.modules()
             if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            module.eval()(video)
    finally:
        for h in hooks:
            h.remove()


@pytest.fixture(scope="module")
def tiny_weights(repo_root):
    """(seeded JAX variables with calibrated running stats, uint8 clips,
    labels) of the tiny TAda2D, drawn once: the options the tests add do
    not change the model's shapes."""
    cfg, jcfg = cfgs(repo_root, TADA, TINY)
    rng = np.random.default_rng(3)
    clips = rng.integers(0, 256, (2, 4, 32, 32, 3), dtype=np.uint8)
    labels = np.array([1, 5], np.int32)
    variables = jax_variables(jax_build_model(jcfg), 4, {"video": jnp.zeros(
        (2, 4, 32, 32, 3), jnp.float32)})
    _calibrate(_port(cfg, variables).module, _video(cfg, clips), variables,
               rng)
    return variables, clips, labels


def _tiny(repo_root, tiny_weights, *opts):
    """(port cfg, JAX cfg, JAX model, a copy of the variables, clips,
    labels) of the tiny TAda2D with ``opts``."""
    cfg, jcfg = cfgs(repo_root, TADA, TINY + list(opts))
    variables, clips, labels = tiny_weights
    variables = jax.tree_util.tree_map(np.copy, variables)
    return cfg, jcfg, jax_build_model(jcfg), variables, clips, labels


def _port(cfg, variables):
    model = build_model(cfg, device="cpu")
    load_jax(model.module, variables)
    return model


def _video(cfg, clips):
    from dist_tpu_torch.tasks.state import _prep_video
    return _prep_video(cfg, torch.from_numpy(clips))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _eval_both(repo_root, tiny_weights, *opts):
    """(port scores, port features, JAX scores, JAX features) in eval
    mode."""
    cfg, jcfg, jmodel, variables, clips, _ = _tiny(repo_root, tiny_weights,
                                                   *opts)
    video = _video(cfg, clips)
    want, wfeat = jax.jit(lambda v, x: jmodel.apply(
        v, {"video": x}, train=False))(variables, jnp.asarray(video.numpy()))
    model = _port(cfg, variables)
    with torch.no_grad():
        got, feat = model.apply({"video": video}, train=False)
    assert got.dtype == torch.float32 and got.shape == (2, 7)
    return got.numpy(), feat.numpy(), np.asarray(want), np.asarray(wfeat)


def test_tiny_tada2d_eval_matches_jax(repo_root, tiny_weights):
    got, feat, want, wfeat = _eval_both(repo_root, tiny_weights)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(feat, wfeat, **FEAT_TOL)
    # not a one-hot: the scores carry the weights
    assert float(want.max()) < 0.99


def test_tiny_tada2d_mixed_precision_matches_jax(repo_root, tiny_weights):
    """Under ``TRAIN.MIXED_PRECISION`` the port's scores are as far from
    the JAX package's as bf16 rounding moves the JAX scores from its own
    fp32 ones (relative L2 within ``BF16_WHOLE_RATIO`` times that): 17
    random, untrained bf16 layers amplify rounding to tens of percent,
    in both packages alike (0.33 against 0.29 on this host)."""
    got, feat, want, wfeat = _eval_both(repo_root, tiny_weights,
                                        "TRAIN.MIXED_PRECISION", "true")
    _, _, want32, _ = _eval_both(repo_root, tiny_weights)
    assert np.isfinite(got).all() and np.isfinite(feat).all()
    assert _rel(got, want) <= BF16_WHOLE_RATIO * _rel(want, want32)


@pytest.mark.parametrize("index", [0, 2], ids=["RouteFuncMLP",
                                               "TAdaConvBlockAvgPool"])
def test_tada_modules_in_bf16_match_jax(repo_root, index):
    """A bf16 input through the route function (fp32 inside) and the TAda
    block (bf16 convs, fp32 BatchNorm islands, ``alpha`` cast to bf16,
    the pool rounded to bf16 once), eval mode: relative L2 distance from
    JAX's bf16 output within ``BF16_REL`` (3.0e-3 on this host for the
    block, whose bf16 output is 5.8e-3 from its fp32 one)."""
    set_bn_frozen(False)
    name, jmod, mod, args = _modules(repo_root)[index]
    variables = jax_variables(jmod, 11 + index, jnp.asarray(args[0]))
    want = jmod.apply(variables, jnp.asarray(args[0], jnp.bfloat16),
                      train=False)
    load_jax(mod, variables).eval()
    with torch.no_grad():
        got = mod(to_ncdhw(args[0]).bfloat16())
    assert got.dtype == (torch.float32 if index == 0 else torch.bfloat16)
    assert _rel(from_ncdhw(got), np.asarray(want, np.float32)) < BF16_REL


def test_bn_freeze_trains_on_running_stats(repo_root, tiny_weights):
    """``BN.FREEZE``: a training forward reads the running stats and moves
    none, as the JAX package's frozen training forward."""
    cfg, jcfg, jmodel, variables, clips, _ = _tiny(repo_root, tiny_weights,
                                                   "BN.FREEZE", "true")
    video = _video(cfg, clips)
    try:
        want, _, new_stats = jax.jit(lambda v, x: jmodel.apply(
            v, {"video": x}, train=True, rngs={"dropout": jax.random.PRNGKey(0)},
            return_new_state=True))(variables, jnp.asarray(video.numpy()))
    finally:
        set_bn_frozen(False)
    assert new_stats is None
    model = _port(cfg, variables)
    before = {k: v.clone() for k, v in _stats(model.module.state_dict()).items()}
    got, _ = model.apply({"video": video}, train=True)
    assert model.module.training and model.module.head.training
    assert not model.module.backbone.conv1.a_bn.training
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for k, v in _stats(model.module.state_dict()).items():
        assert torch.equal(v, before[k]), k


def test_sgd_step_matches_jax(repo_root, tiny_weights):
    """One step of the config's SGD (Nesterov momentum 0.9, weight decay
    1e-4, ConvBN's BN parameters in their own group without decay) at LR
    0.48: the loss (``rtol=1e-5``), every weight's update (within 1e-3 of
    the tensor's largest update plus 1e-5: the step multiplies the
    gradients' rounding by 0.48 * 1.9, and a bias before a BatchNorm has
    a gradient of rounding alone) and the running stats
    (``STEP_STATS_TOL``)."""
    cfg, jcfg, jmodel, variables, clips, labels = _tiny(repo_root,
                                                        tiny_weights)
    tx, jlr = jopt.construct_optimizer(jcfg, variables, 4)
    jstep = jax.jit(jstate.make_train_step(jmodel, jcfg, tx, jlr))
    state, metrics = jstep(jstate.create_train_state(variables, tx),
                           {"video": jnp.asarray(clips),
                            "labels": jnp.asarray(labels)},
                           jax.random.PRNGKey(0))
    after = jax.device_get(state.variables)

    model = _port(cfg, variables)
    optimizer, lr_fn = construct_optimizer(cfg, model.module, 4)
    pstate = create_train_state(model, optimizer)
    step = make_train_step(model, cfg, optimizer, lr_fn)
    got = step(pstate, {"video": torch.from_numpy(clips),
                        "labels": torch.from_numpy(labels).long()})
    assert lr_fn(0) == pytest.approx(0.48) == float(jlr(0))
    np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]),
                               rtol=1e-5)
    want = state_dict_from_jax(after, model.module)
    before = state_dict_from_jax(variables, model.module)
    sd = model.module.state_dict()
    for k, v in model.module.named_parameters():
        step_want = want[k] - before[k]
        scale = float(np.abs(step_want).max())
        assert scale > 0, k      # every weight moved
        np.testing.assert_allclose(v.detach().numpy() - before[k], step_want,
                                   atol=1e-3 * scale + 1e-5, rtol=0,
                                   err_msg=k)
    for k, v in _stats(sd).items():
        np.testing.assert_allclose(v.numpy(), want[k], err_msg=k,
                                   **STEP_STATS_TOL)


def test_eval_step_after_a_train_step_runs_in_eval_mode(repo_root,
                                                         tiny_weights):
    """After a train step, the eval step (and its EMA form) gives a fresh
    eval-mode forward's preds with the same weights, and leaves the
    running stats as they were."""
    cfg, _, _, variables, clips, labels = _tiny(
        repo_root, tiny_weights, "MODEL.EMA.ENABLE", "true", "MODEL.EMA.DECAY", "0.5",
        "OPTIMIZER.BASE_LR", "0.0001")
    model = _port(cfg, variables)
    initial = {k: v.clone() for k, v in model.module.state_dict().items()}
    optimizer, lr_fn = construct_optimizer(cfg, model.module, 4)
    state = create_train_state(model, optimizer, 0.5)
    make_train_step(model, cfg, optimizer, lr_fn)(
        state, {"video": torch.from_numpy(clips),
                "labels": torch.from_numpy(labels).long()})
    trained = {k: v.clone() for k, v in model.module.state_dict().items()}
    batch = {"video": torch.from_numpy(clips[::-1].copy()),
             "labels": torch.from_numpy(labels).long()}
    preds = make_eval_step(model, cfg)(batch)["preds"]
    ema_preds = make_eval_step(model, cfg, use_ema=True)(batch, state)["preds"]
    for k, v in model.module.state_dict().items():
        assert torch.equal(v, trained[k]), k
    # the EMA copy averages the running stats too
    for k in _stats(trained):
        torch.testing.assert_close(state.ema[k], (initial[k] + trained[k]) / 2)
        assert not torch.equal(initial[k], trained[k])
    for weights, got in ((trained, preds), (state.ema, ema_preds)):
        fresh = build_model(cfg, device="cpu", seed=99)
        fresh.module.load_state_dict(weights)
        with torch.no_grad():
            want, _ = fresh.module(_video(cfg, batch["video"].numpy()))
        torch.testing.assert_close(got, want, rtol=0, atol=0)
