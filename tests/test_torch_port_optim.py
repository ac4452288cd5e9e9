"""The port's optimizer pieces against the JAX package's, on the CPU: the
LR policies, the supervised losses, ``topks_correct``, the parameter
groups of ``param_labels`` and the optimizer's updates (``optax`` against
``torch.optim``) on the same fixed gradients."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dist_tpu.config import load_config as jax_load_config
from dist_tpu.models.base.models import build_model as jax_build_model
from dist_tpu.optim import losses as jlosses
from dist_tpu.optim import lr_policy as jlr
from dist_tpu.optim import optimizer as jopt
from dist_tpu.tasks.state import init_variables
from dist_tpu.utils import metrics as jmetrics
from dist_tpu_torch.config import load_config
from dist_tpu_torch.models.base.models import build_model
from dist_tpu_torch.models.clip.convert import state_dict_from_jax, to_torch
from dist_tpu_torch.optim import losses, lr_policy, optimizer
from dist_tpu_torch.utils import metrics

FLAGSHIP = "configs/projects/dist/ssv2/vit-b16-8+16f.yaml"
TINY = "configs/projects/dist/test/tiny_synth.yaml"
STEPS = ["OPTIMIZER.LR_POLICY", "steps_with_relative_lrs",
         "OPTIMIZER.LR_MILESTONES", "[0, 10, 20]",
         "OPTIMIZER.LRS", "[1, 0.1, 0.01]"]


def _cfgs(repo_root, path, opts=()):
    path = os.path.join(repo_root, path)
    return (load_config(path, list(opts), make_output_dir=False),
            jax_load_config(path, list(opts), make_output_dir=False))


@pytest.mark.parametrize("opts", [[], STEPS], ids=["cosine", "steps"])
def test_lr_at_epoch_matches_jax(repo_root, opts):
    """Cosine with 6 warmup epochs over 36 (the flagship), and steps with
    relative LRs, on a grid of fractional epochs through the warmup edge.
    The JAX package evaluates in float32: rtol 1e-6, and an absolute
    1e-7 * BASE_LR for its cos term's rounding (~6e-8) where cos + 1
    cancels near the end of the schedule."""
    cfg, jcfg = _cfgs(repo_root, FLAGSHIP, opts)
    tol = dict(rtol=1e-6, atol=1e-7 * float(cfg.OPTIMIZER.BASE_LR))
    epochs = np.concatenate([np.linspace(0, 36, 73), [5.99, 6.0, 6.01, 9.99,
                                                      10.0, 19.99, 20.0]])
    got = [lr_policy.get_lr_at_epoch(cfg, float(e)) for e in epochs]
    want = [float(jlr.get_lr_at_epoch(jcfg, float(e))) for e in epochs]
    np.testing.assert_allclose(got, want, **tol)
    sched = lr_policy.lr_schedule_by_step(cfg, steps_per_epoch=7)
    jsched = jlr.lr_schedule_by_step(jcfg, steps_per_epoch=7)
    np.testing.assert_allclose([sched(k) for k in range(0, 200, 3)],
                               [float(jsched(k)) for k in range(0, 200, 3)],
                               **tol)


@pytest.mark.parametrize("name", ["soft_target", "cross_entropy", "bce",
                                  "bce_logit", "mse"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 11)).astype(np.float32)
    labels = rng.integers(0, 11, 6)
    soft = jlosses.label_smoothing(jnp.asarray(labels), 11, 0.1)
    if name == "cross_entropy":
        target, jtarget = torch.from_numpy(labels), jnp.asarray(labels)
    else:
        target, jtarget = torch.from_numpy(np.array(soft)), soft
    x = 1 / (1 + np.exp(-logits)) if name == "bce" else logits
    got = losses.get_loss_func(name)(torch.from_numpy(x), target)
    want = jlosses.get_loss_func(name)(jnp.asarray(x), jtarget)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_label_smoothing_and_calculate_loss_match_jax(repo_root):
    """The flagship's supervised loss (label smoothing 0.1, soft-target CE)
    and the mixup path, against the JAX dispatch."""
    cfg, jcfg = _cfgs(repo_root, FLAGSHIP)
    rng = np.random.default_rng(4)
    preds = rng.standard_normal((5, 174)).astype(np.float32)
    labels = rng.integers(0, 174, 5)
    np.testing.assert_array_equal(
        losses.label_smoothing(torch.from_numpy(labels), 174, 0.1).numpy(),
        np.asarray(jlosses.label_smoothing(jnp.asarray(labels), 174, 0.1)))
    mix = rng.dirichlet(np.ones(174), 5).astype(np.float32)
    for lab in ({"supervised": labels},
                {"supervised": labels, "supervised_mixup": mix}):
        got, _ = losses.calculate_loss(
            cfg, torch.from_numpy(preds), None,
            {k: torch.from_numpy(v) for k, v in lab.items()})
        want, _ = jlosses.calculate_loss(
            jcfg, jnp.asarray(preds), None,
            {k: jnp.asarray(v) for k, v in lab.items()})
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # dict targets (EPIC verb/noun heads) sum per-key losses
    heads = {"verb_class": preds[:, :97], "noun_class": preds[:, 97:]}
    targets = {k: rng.integers(0, v.shape[1], 5) for k, v in heads.items()}
    for key in ("supervised", "supervised_mixup"):
        lab = {"supervised": targets}
        if key == "supervised_mixup":
            lab[key] = {k: rng.dirichlet(np.ones(v.shape[1]), 5).astype(
                np.float32) for k, v in heads.items()}
        got, parts = losses.calculate_loss(
            cfg, {k: torch.from_numpy(v) for k, v in heads.items()}, None,
            {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()}
             for k, v in lab.items()})
        want, jparts = jlosses.calculate_loss(
            jcfg, {k: jnp.asarray(v) for k, v in heads.items()}, None,
            {k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
             for k, v in lab.items()})
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        assert sorted(parts) == sorted(jparts)


def test_unported_losses_raise(repo_root):
    """Both the TAL losses and the SSL losses are ported:
    ``LOCALIZATION.ENABLE`` dispatches to the BMN losses (``LOSS`` split
    on ``+``, weighted by ``LOSS_WEIGHTS``; ROADMAP.md queue A, item 6),
    ``PRETRAIN.ENABLE`` to the SSL losses."""
    cfg, _ = _cfgs(repo_root, "configs/projects/tal/bmn_epic100.yaml")
    preds = {"start": torch.full((2, 4), 0.5), "end": torch.full((2, 4), 0.5),
             "confidence_map": torch.full((2, 2, 3, 4), 0.5)}
    maps = {"start_map": torch.ones(2, 4), "end_map": torch.zeros(2, 4),
            "iou_map": torch.full((2, 3, 4), 0.8),
            "mask": torch.ones(2, 3, 4)}
    loss, parts = losses.calculate_loss(cfg, preds, None,
                                        {"supervised": maps}, cur_epoch=1)
    assert sorted(parts) == ["pem_cls", "pem_reg", "tem"]
    weights = dict(zip(("tem", "pem_reg", "pem_cls"),
                       cfg.LOCALIZATION.LOSS_WEIGHTS))
    torch.testing.assert_close(
        loss, sum(weights[k] * v for k, v in parts.items()))
    cfg, _ = _cfgs(repo_root, "configs/projects/hico/simclr_k400_s3dg.yaml")
    emb = torch.nn.functional.normalize(torch.randn(4, 8), dim=-1)
    loss, parts = losses.calculate_loss(
        cfg, torch.zeros(4, 3), emb, {"supervised": torch.zeros(2).long(),
                                      "self-supervised": {
                                          "contrastive": torch.zeros(2, 2)}})
    assert torch.isfinite(loss) and "loss_contrastive" in parts


def test_topks_correct_matches_jax_with_k_clamped():
    rng = np.random.default_rng(5)
    preds = rng.standard_normal((9, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 9)
    weights = (rng.random(9) > 0.3).astype(np.float32)
    for w in (None, weights):
        got = metrics.topks_correct(torch.from_numpy(preds),
                                    torch.from_numpy(labels), (1, 2, 5),
                                    None if w is None else torch.from_numpy(w))
        want = jmetrics.topks_correct(jnp.asarray(preds), jnp.asarray(labels),
                                      (1, 2, 5), None if w is None
                                      else jnp.asarray(w))
        assert [float(g) for g in got] == [float(v) for v in want]
    assert float(got[2]) == float(weights.sum())             # k=5 -> all 3


_CODES = {jopt.FROZEN: 0, jopt.NO_WD: 1, jopt.TRAINABLE: 2, jopt.BODY: 3,
          jopt.BN: 4}
# stacked on the ladder's axis in the JAX package, so 2-D to its "ndim <= 1"
# rule there; one 1-D tensor per ladder step in the port (optimizer.py)
LADDER_LN = ("dist_net.temporal_nets.", "dist_net.integration_nets.")


def _is_ladder_ln_scale(name):
    return name.startswith(LADDER_LN) and ".ln" in name and name.endswith(
        ".weight")


@pytest.fixture(scope="module")
def tiny(repo_root):
    """The tiny config on both sides with the JAX package's initial
    weights."""
    cfg, jcfg = _cfgs(repo_root, TINY, ["TRAIN.MIXED_PRECISION", "false"])
    jmodel = jax_build_model(jcfg)
    variables = jax.device_get(init_variables(jcfg, jmodel, (4, 64, 64, 3)))
    return cfg, jcfg, variables


def _port_module(cfg, variables):
    model = build_model(cfg, device="cpu")
    model.module.load_state_dict(to_torch(state_dict_from_jax(
        variables["params"])))
    return model.module


def _port_codes(tree):
    """A JAX-layout tree of per-leaf label codes, under the port's names."""
    return {k: int(np.unique(v).item()) for k, v in
            state_dict_from_jax(tree).items()}


@pytest.mark.parametrize("opts", [[], ["VIDEO.BACKBONE.DIST.ENABLE", "false",
                                        "VIDEO.BACKBONE.FREEZE_VISUAL", "false",
                                        "TRAIN.LR_REDUCE", "true",
                                        "TRAIN.FINE_TUNE", "true"]],
                         ids=["dist", "standard"])
def test_param_groups_match_jax_labels(repo_root, tiny, opts):
    """Every port parameter's group equals the JAX package's label of the
    same weight (mapped through ``state_dict_from_jax``), but for the
    ladder's LayerNorm scales under the DiST grouping (see LADDER_LN). The
    standard grouping (no DiST, trainable vision tower, frozen text tower,
    body LR reduced) labels the towers' weights only."""
    cfg, jcfg = _cfgs(repo_root, TINY, opts)
    _, _, variables = tiny
    labels = jopt.param_labels(jcfg, variables)["params"]
    codes = jax.tree_util.tree_map(
        lambda lab, leaf: np.full(np.shape(leaf), _CODES[lab]), labels,
        variables["params"])
    want = _port_codes(codes)
    module = build_model(cfg, device="cpu").module
    got = {k: _CODES[v] for k, v in
           optimizer.param_labels(cfg, module).items()}
    dist = not opts
    if dist:
        assert sorted(got) == sorted(want)
    else:
        assert not any(k.startswith("dist_net.") for k in got)
        want = {k: want[k] for k in got}
    moved = {k for k in got if got[k] != want[k]}
    if dist:
        assert moved == {k for k in got if _is_ladder_ln_scale(k)}
        assert all(want[k] == _CODES[jopt.TRAINABLE] and
                   got[k] == _CODES[jopt.NO_WD] for k in moved)
    else:
        assert not moved
    assert len(set(got.values())) == 3


@pytest.mark.parametrize("method", ["adamw", "adam", "sgd"])
def test_updates_match_optax(repo_root, tiny, method):
    """Three steps on the same fixed gradients (JAX layout, mapped to the
    port's): every parameter equals the optax result within 1e-6; the
    frozen ones do not move. Under the DiST grouping the ladder's
    LayerNorm scales decay in the JAX package only (LADDER_LN):
    3 * lr * mult * wd * |w| < 1e-7 here."""
    cfg, jcfg = _cfgs(repo_root, TINY, ["OPTIMIZER.OPTIM_METHOD", method])
    _, _, variables = tiny
    rng = np.random.default_rng(6)
    grads = jax.tree_util.tree_map(
        lambda p: rng.standard_normal(np.shape(p)).astype(np.float32),
        variables)
    tx, jlr_fn = jopt.construct_optimizer(jcfg, variables, 4)
    params, state = variables, tx.init(variables)
    for _ in range(3):
        updates, state = tx.update(grads, state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    want = state_dict_from_jax(jax.device_get(params)["params"])

    module = _port_module(cfg, variables)
    start = {k: v.clone() for k, v in module.state_dict().items()}
    opt, lr_fn = optimizer.construct_optimizer(cfg, module, 4)
    tgrads = to_torch(state_dict_from_jax(grads["params"]))
    for step in range(3):
        for k, p in module.named_parameters():
            if p.requires_grad:
                p.grad = tgrads[k].clone()
        assert lr_fn(step) == pytest.approx(float(jlr_fn(step)), rel=1e-6)
        optimizer.set_lr(opt, lr_fn(step))
        opt.step()
    labels = optimizer.param_labels(cfg, module)
    for k, p in module.named_parameters():
        if labels[k] == optimizer.FROZEN:
            assert not p.requires_grad and torch.equal(p, start[k]), k
        np.testing.assert_allclose(p.detach().numpy(), want[k], atol=1e-6,
                                   rtol=0, err_msg=k)
    assert any(not torch.equal(p, start[k])
               for k, p in module.named_parameters())


def test_adjust_lr_scales_by_the_one_card_batch(repo_root, tiny):
    """ADJUST_LR scales BASE_LR by the global batch / 256; on one card
    the global batch is TRAIN.BATCH_SIZE, the JAX package's rule with a
    data axis of one device."""
    from dist_tpu.parallel.mesh import config_data_axis_size

    opts = ["OPTIMIZER.ADJUST_LR", "true", "TRAIN.BATCH_SIZE", "64"]
    cfg, jcfg = _cfgs(repo_root, TINY, opts)
    module = _port_module(cfg, tiny[2])
    _, lr_fn = optimizer.construct_optimizer(cfg, module, 4)
    want = jopt.base_lr(jcfg) / config_data_axis_size(jcfg)
    assert optimizer.base_lr(cfg) == pytest.approx(want, rel=1e-12)
    assert lr_fn(0) == pytest.approx(float(cfg.OPTIMIZER.BASE_LR) * 64 / 256,
                                     rel=1e-6)


def test_lars_raises(repo_root):
    """``lars`` builds the port's ``LARS`` (held to the JAX chain by
    ``tests/test_torch_port_lars.py``), and an unknown method raises."""
    cfg, _ = _cfgs(repo_root, TINY, ["OPTIMIZER.OPTIM_METHOD", "lars"])
    opt, _ = optimizer.construct_optimizer(cfg, build_model(cfg, device="cpu")
                                           .module, 4)
    assert isinstance(opt, optimizer.LARS)
    cfg, _ = _cfgs(repo_root, TINY, ["OPTIMIZER.OPTIM_METHOD", "lamb"])
    with pytest.raises(NotImplementedError, match="lamb"):
        optimizer.construct_optimizer(cfg, build_model(cfg, device="cpu")
                                      .module, 4)


TADA = "configs/projects/tada/k400/tada2d_8x8.yaml"
# an LR of 1000 at step 0, so that a step's decay (LR * 1.9 * 1e-4 of a
# weight) is far above fp32's rounding of the weight
TADA_TINY = ["VIDEO.BACKBONE.DEPTH", "18",
             "VIDEO.BACKBONE.NUM_FILTERS", "[8, 16, 32, 64, 128]",
             "DATA.NUM_INPUT_FRAMES", "4", "VIDEO.HEAD.NUM_CLASSES", "7",
             "OPTIMIZER.WARMUP_EPOCHS", "0", "OPTIMIZER.BASE_LR", "1000"]


def _jax_leaf(tree, leaf):
    node = tree[leaf.collection]
    for seg in leaf.path.split("/"):
        node = node[seg]
    return node


def _port_probe(cfg, module, value, grad):
    """Each parameter's change in one step of the port's optimizer from
    ``value`` with gradient ``grad`` everywhere."""
    with torch.no_grad():
        for p in module.parameters():
            p.fill_(value)
    opt, lr_fn = optimizer.construct_optimizer(cfg, module, 4)
    for p in module.parameters():
        p.grad = torch.full_like(p, grad)
    optimizer.set_lr(opt, lr_fn(0))
    opt.step()
    return {k: p.detach().numpy() - value for k, p in module.named_parameters()}


def _groups_match_jax(repo_root, path, opts, frames):
    """Every parameter's group equals the JAX package's label of its
    counterpart (``models/backbones/convert.py::jax_table``), and one
    step of each optimizer moves it alike: from 0 with gradient 1 (the
    group's LR multiplier) and from 1 with gradient 0 (its weight decay),
    within ``rtol=1e-5``. Returns the port's labels."""
    from dist_tpu_torch.models.backbones.convert import jax_table

    cfg, jcfg = _cfgs(repo_root, path, opts)
    shapes = jax.eval_shape(lambda: jax_build_model(jcfg).init(
        jax.random.PRNGKey(0), {"video": jnp.zeros((1, frames, 32, 32, 3))}))
    zeros, ones = (jax.tree_util.tree_map(
        lambda s: np.full(s.shape, v, np.float32), shapes) for v in (0, 1))
    labels = jopt.param_labels(jcfg, zeros)
    tx, jlr_fn = jopt.construct_optimizer(jcfg, zeros, 4)
    update = jax.jit(lambda g, p: tx.update(g, tx.init(p), p)[0])
    per_grad, per_decay = update(ones, zeros), update(zeros, ones)

    module = build_model(cfg, device="cpu").module
    table = jax_table(module)
    got = optimizer.param_labels(cfg, module)
    got_grad = _port_probe(cfg, module, 0.0, 1.0)
    got_decay = _port_probe(cfg, module, 1.0, 0.0)
    for k in got:
        leaf = table[k]
        assert got[k] == _jax_leaf(labels, leaf), k
        # every entry of a tensor moves alike: one value each
        for probe, want in ((got_grad, per_grad), (got_decay, per_decay)):
            (g,), (w,) = np.unique(probe[k]), np.unique(_jax_leaf(want, leaf))
            assert g == pytest.approx(float(w), rel=1e-5), k
    return got


@pytest.mark.parametrize("opts", [[], ["TRAIN.LR_REDUCE", "true"]],
                         ids=["sgd", "lr_reduce"])
def test_tada2d_groups_match_jax_through_the_table(repo_root, opts):
    """Every TAda2D parameter's group equals the JAX package's label of
    its counterpart (``models/backbones/convert.py::jax_table``), and one
    step of each optimizer moves it alike: from 0 with gradient 1 (the
    group's LR multiplier) and from 1 with gradient 0 (its weight decay),
    within ``rtol=1e-5``. ConvBN's BatchNorm (JAX ``.../bn``, the port's
    ``..._bn``) is in the BN group without decay; the TAda block's own
    ``a_bn``, ``b_bn`` ... are not, in both packages."""
    got = _groups_match_jax(repo_root, TADA, TADA_TINY + opts, 4)
    assert got["backbone.conv1.a_bn.weight"] == optimizer.BN
    assert got["backbone.conv2.res_1.conv_branch.b_rf.bn.weight"] == optimizer.BN
    assert got["backbone.conv2.res_1.conv_branch.a_bn.weight"] != optimizer.BN
    assert len(set(got.values())) == (3 if opts else 2)


# the fine-tune configs (SGD, Nesterov, weight decay 1e-4, BN.WEIGHT_DECAY
# 0), tiny: an LR of 1000 at step 0, as TADA_TINY
CONV_TINY = ["DATA.NUM_INPUT_FRAMES", "8", "OPTIMIZER.WARMUP_EPOCHS", "0",
             "OPTIMIZER.BASE_LR", "1000", "TRAIN.CHECKPOINT_FILE_PATH", ""]
SLOWFAST_TINY = ["VIDEO.BACKBONE.NUM_FILTERS", "[32, 32, 64, 128, 256]",
                 "VIDEO.HEAD.NUM_CLASSES", "[5, 7]"]


@pytest.mark.parametrize("opts", [[], ["TRAIN.LR_REDUCE", "true"]],
                         ids=["sgd", "lr_reduce"])
@pytest.mark.parametrize("path", [
    "configs/projects/tada/slowfast_ek100.yaml",
    "configs/projects/hico/ft_s3dg_hmdb.yaml"], ids=["slowfast", "s3dg"])
def test_slowfast_and_s3dg_groups_match_jax_through_the_table(repo_root,
                                                              path, opts):
    """SlowFast with ``SlowFastHeadx2`` and S3D-G with ``BaseHead``, each
    parameter's group and one step's moves as the JAX package's (see
    ``_groups_match_jax``). JAX's rule is a path segment that starts with
    ``bn`` or contains ``norm``: the fusion BatchNorm ``fusionN/bn`` and
    S3D-G's ``bn`` and ``bn2`` are in the BN group (``BN.WEIGHT_DECAY``);
    ``SelfGating``'s ``fc`` and the heads decay."""
    slowfast = "slowfast" in path
    got = _groups_match_jax(repo_root, path, CONV_TINY + opts
                            + (SLOWFAST_TINY if slowfast else []), 8)
    if slowfast:
        assert got["backbone.fusion1.bn.weight"] == optimizer.BN
        assert got["backbone.slow_conv1.a_bn.weight"] == optimizer.BN
        assert got["backbone.fast_conv2.res_1_branch.a_bn.bias"] == \
            optimizer.BN
        decayed = ["backbone.fusion1.conv_f2s.weight",
                   "backbone.slow_conv2.res_1_branch.a.weight",
                   "head.out1.weight", "head.out2.weight"]
    else:
        for name in ("backbone.Conv_1a.bn.weight", "backbone.Conv_1a.bn2.bias",
                     "backbone.Mixed_3b.branch1_1.bn2.weight"):
            assert got[name] == optimizer.BN, name
        decayed = ["backbone.Mixed_3b.gating_b0.fc.weight",
                   "backbone.Mixed_5c.gating_b3.fc.bias", "head.out.weight"]
    trained = optimizer.BODY if opts else optimizer.TRAINABLE
    for name in decayed:
        want = optimizer.TRAINABLE if name.startswith("head.") else trained
        assert got[name] == want, name
