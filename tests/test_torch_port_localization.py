"""The port's temporal action localization against the JAX package's on
the CPU, at ``tests/test_localization.py::_loc_cfg``'s geometry (16
snippets of 12 features, ``DIM1D`` 16, ``DSCALE`` 8), over
``configs/projects/tal/bmn_epic100.yaml``:

- ``proposal_window_means`` at ``atol=1e-6``;
- ``SimpleLocalizationConv`` + ``BMNHead`` (one group and a single class
  count; four groups and the verb/noun maps) on seeded JAX weights
  brought across by ``models/backbones/convert.py``, the JAX apply
  jitted: every output at ``atol=1e-5``;
- each BMN loss on the same predictions, ``Loss_PemReg`` fed the JAX
  package's own masks, at ``rtol=1e-5``;
- one step's loss and gradients, every leaf within 1e-4 of its largest
  entry, and the Adam parameter groups through the table;
- the ``tal/`` chain (proposals, post-processing, ``EpicDetection``)
  equal to ``dist_tpu.tal``'s on the same predictions;
- the full-width config one to one with the JAX tree, and
  ``TASK_TYPE: localization`` refused by the run list as in JAX."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dist_tpu.models.base.models import build_model as jax_build_model
from dist_tpu.models.heads import bmn as jax_bmn
from dist_tpu.optim import localization as jax_loc
from dist_tpu.optim import optimizer as jopt
from dist_tpu.optim.losses import calculate_loss as jax_calculate_loss
from dist_tpu.tal import eval as jax_tal_eval
from dist_tpu.tal import tools as jax_tal_tools
from dist_tpu_torch import run
from dist_tpu_torch.models.backbones.convert import jax_table, state_dict_from_jax
from dist_tpu_torch.models.base.models import build_backbone_on_meta, build_model
from dist_tpu_torch.models.heads import bmn
from dist_tpu_torch.optim import localization, optimizer
from dist_tpu_torch.optim.losses import calculate_loss
from dist_tpu_torch.tal import eval as tal_eval
from dist_tpu_torch.tal import tools as tal_tools
from tests.test_torch_port_optim import _jax_leaf, _port_probe
from tests.test_torch_port_resnet3d import cfgs, jax_variables

BMN = "configs/projects/tal/bmn_epic100.yaml"
TINY = ["DATA.NUM_INPUT_CHANNELS", "12", "DATA.NUM_INPUT_FRAMES", "16",
        "VIDEO.DIM1D", "16", "LOCALIZATION.DSCALE", "8",
        "TRAIN.CHECKPOINT_FILE_PATH", ""]
CASES = {
    "one_group": ["VIDEO.BACKBONE_GROUPS_NUM", "1",
                  "VIDEO.HEAD.NUM_CLASSES", "10"],
    "epic_maps": ["VIDEO.BACKBONE_GROUPS_NUM", "4",
                  "VIDEO.HEAD.NUM_CLASSES", "[6, 9]",
                  "LOCALIZATION.LOSS", "Tem+PemReg+PemCls+BmnActionCls",
                  "LOCALIZATION.LOSS_WEIGHTS", "[1.0, 10.0, 1.0, 1.0]"],
}
FORWARD_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
STEP = 3


def _models(repo_root, case, seed=0):
    """(port cfg, JAX cfg, port model, JAX model, JAX variables, feats):
    the port model holding the JAX model's seeded weights."""
    cfg, jcfg = cfgs(repo_root, BMN, TINY + CASES[case])
    jmodel = jax_build_model(jcfg)
    feats = np.random.default_rng(seed).standard_normal((2, 16, 12)) \
        .astype(np.float32)
    variables = jax_variables(jmodel, seed + 1,
                              {"video": jnp.zeros(feats.shape)})
    model = build_model(cfg, device="cpu")
    sd = state_dict_from_jax(variables, model.module)
    model.module.load_state_dict({k: torch.from_numpy(v)
                                  for k, v in sd.items()})
    return cfg, jcfg, model, jmodel, variables, feats


def _labels(seed, d=8, t=16, classes=(6, 9)):
    rng = np.random.default_rng(seed)
    return {"supervised": {
        "start_map": (rng.uniform(size=(2, t)) > 0.6).astype(np.float32),
        "end_map": (rng.uniform(size=(2, t)) > 0.6).astype(np.float32),
        "iou_map": rng.uniform(size=(2, d, t)).astype(np.float32),
        "mask": (rng.uniform(size=(2, d, t)) > 0.2).astype(np.float32),
        "label_map": np.stack([rng.integers(0, classes[0], (2, d, t)),
                               rng.integers(0, classes[1], (2, d, t))],
                              axis=1)}}


def _torch_labels(labels):
    return {"supervised": {k: torch.from_numpy(np.asarray(v))
                           for k, v in labels["supervised"].items()}}


def jax_pem_reg_draws(shape, step):
    """The JAX package's ``Loss_PemReg`` draws for ``step``."""
    key = jax.random.fold_in(jax.random.PRNGKey(0),
                             jnp.asarray(step * 1000, jnp.int32))
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.uniform(k1, shape)),
            np.asarray(jax.random.uniform(k2, shape)))


def test_window_means_match_jax():
    x = np.random.default_rng(3).standard_normal((2, 11, 5)) \
        .astype(np.float32)
    want = np.asarray(jax_bmn.proposal_window_means(jnp.asarray(x), 7))
    got = bmn.proposal_window_means(torch.from_numpy(x).transpose(1, 2), 7)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-6)
    # a window past the end is zero
    assert float(got[:, :, 6, 5:].abs().max()) == 0.0


@pytest.mark.parametrize("case", list(CASES))
def test_bmn_forward_matches_jax(repo_root, case):
    cfg, jcfg, model, jmodel, variables, feats = _models(repo_root, case)
    want, wlogits = jax.jit(lambda v, x: jmodel.apply(
        v, {"video": x}, train=False))(variables, jnp.asarray(feats))
    with torch.no_grad():
        got, logits = model.apply({"video": torch.from_numpy(feats)})
    assert sorted(got) == sorted(want)
    if case == "epic_maps":
        assert got["verb_map"].shape == (2, 6, 8, 16)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=FORWARD_ATOL, err_msg=k)
    np.testing.assert_allclose(logits.transpose(1, 2).numpy(),
                               np.asarray(wlogits), atol=FORWARD_ATOL)


@pytest.mark.parametrize("name", ["Loss_Tem", "Loss_PemReg", "Loss_PemCls",
                                  "Loss_BmnActionCls"])
def test_each_loss_matches_jax(repo_root, name):
    """Each loss on the same predictions (the JAX model's), the JAX
    package's sampling masks fed to ``Loss_PemReg``."""
    cfg, jcfg, model, jmodel, variables, feats = _models(repo_root,
                                                         "epic_maps")
    preds, _ = jmodel.apply(variables, {"video": jnp.asarray(feats)},
                            train=True)
    labels = _labels(5)
    jparts, _ = getattr(jax_loc, name)(jcfg, preds, None, labels,
                                       cur_epoch=STEP)
    kwargs = {}
    if name == "Loss_PemReg":
        kwargs["draws"] = jax_pem_reg_draws((2, 8, 16), STEP)
    parts, _ = getattr(localization, name)(
        cfg, {k: torch.tensor(np.asarray(v)) for k, v in preds.items()},
        None, _torch_labels(labels), cur_epoch=STEP, **kwargs)
    assert sorted(parts) == sorted(jparts)
    for k in jparts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   rtol=LOSS_RTOL, err_msg=k)


def test_pem_reg_draws_are_the_steps_alone():
    a1, a2 = localization.pem_reg_draws((2, 3), 4)
    b1, _ = localization.pem_reg_draws((2, 3), 4)
    c1, _ = localization.pem_reg_draws((2, 3), 5)
    assert torch.equal(a1, b1) and not torch.equal(a1, a2)
    assert not torch.equal(a1, c1)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradients_match_jax(repo_root, case, monkeypatch):
    """One step's loss through ``calculate_loss`` and every parameter's
    gradient, against ``jax.grad`` of the JAX package's, with the JAX
    sampling masks."""
    cfg, jcfg, model, jmodel, variables, feats = _models(repo_root, case)
    labels = _labels(7)

    def jloss(v):
        preds, logits = jmodel.apply(v, {"video": jnp.asarray(feats)},
                                     train=True)
        return jax_calculate_loss(jcfg, preds, logits, labels,
                                  cur_epoch=STEP)

    (want, wparts), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(variables)
    monkeypatch.setattr(localization, "pem_reg_draws",
                        lambda shape, step: jax_pem_reg_draws(shape, step))
    preds, logits = model.apply({"video": torch.from_numpy(feats)},
                                train=True)
    loss, parts = calculate_loss(cfg, preds, logits, _torch_labels(labels),
                                 cur_epoch=STEP)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    assert sorted(parts) == sorted(wparts)
    want_grads = state_dict_from_jax(jgrads, model.module)
    for k, p in model.module.named_parameters():
        w = want_grads[k]
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= GRAD_REL * max(np.abs(w).max(), 1e-6), (k, err)


def test_adam_groups_match_jax_through_the_table(repo_root):
    """BMN's Adam: every parameter's group equals the JAX label of its
    counterpart, and one step moves it alike (from 0 with gradient 1,
    from 1 with gradient 0) within ``rtol=1e-5``."""
    # an LR of 1000, so that the decay's move reads in fp32
    cfg, jcfg = cfgs(repo_root, BMN, TINY + CASES["epic_maps"]
                     + ["OPTIMIZER.BASE_LR", "1000"])
    shapes = jax.eval_shape(lambda: jax_build_model(jcfg).init(
        jax.random.PRNGKey(0), {"video": jnp.zeros((1, 16, 12))}))
    zeros, ones = (jax.tree_util.tree_map(
        lambda s: np.full(s.shape, v, np.float32), shapes) for v in (0, 1))
    labels = jopt.param_labels(jcfg, zeros)
    tx, _ = jopt.construct_optimizer(jcfg, zeros, 4)
    update = jax.jit(lambda g, p: tx.update(g, tx.init(p), p)[0])
    per_grad, per_decay = update(ones, zeros), update(zeros, ones)
    module = build_model(cfg, device="cpu").module
    table = jax_table(module)
    got = optimizer.param_labels(cfg, module)
    got_grad = _port_probe(cfg, module, 0.0, 1.0)
    got_decay = _port_probe(cfg, module, 1.0, 0.0)
    assert len(got) == len(jax.tree_util.tree_leaves(zeros))
    for k in got:
        assert got[k] == _jax_leaf(labels, table[k]), k
        for probe, want in ((got_grad, per_grad), (got_decay, per_decay)):
            (g,), (w,) = np.unique(probe[k]), np.unique(
                _jax_leaf(want, table[k]))
            assert g == pytest.approx(float(w), rel=1e-5), k


def test_train_step_takes_the_label_dict(repo_root):
    """The port's train step on features and the label dict: Adam steps
    the weights, the losses are finite and the errors count 0."""
    from dist_tpu_torch.tasks.state import create_train_state, make_train_step

    cfg, _, model, _, _, feats = _models(repo_root, "epic_maps")
    opt, lr_fn = optimizer.construct_optimizer(cfg, model.module, 4)
    step = make_train_step(model, cfg, opt, lr_fn)
    state = create_train_state(model, opt)
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    batch = {"video": torch.from_numpy(feats),
             "labels": _torch_labels(_labels(9))["supervised"]}
    for _ in range(2):
        metrics = step(state, batch)
        assert np.isfinite(float(metrics["loss"]))
        assert float(metrics["top1_err"]) == 0.0
        assert {"tem", "pem_reg", "pem_cls", "verb_loss"} <= set(metrics)
    assert state.step == 2
    moved = [k for k, v in model.module.state_dict().items()
             if not torch.equal(v, before[k])]
    assert len(moved) == len(before)


def _chain(tools, ev, cfg, preds, tmp_path, tag):
    """parse -> post-process -> EpicDetection against ground truth made
    from each video's top detection; -> (detections, results)."""
    video_props = {}
    for b, (name, duration) in enumerate((("v1", 12.0), ("v2", 20.0))):
        props = tools.parse_bmn_proposals(
            preds["start"][b], preds["end"][b], preds["confidence_map"][b],
            verb_map=preds["verb_map"][b], noun_map=preds["noun_map"][b],
            top_k=5)
        video_props[name] = (props, duration)
    out = str(tmp_path / f"{tag}_detections.json")
    output, _ = tools.localization_post_processing(cfg, video_props,
                                                   out_path=out)
    gt = {"database": {}}
    for name, dets in output["results"].items():
        top = max(dets, key=lambda d: d["score"])
        gt["database"][name] = {"subset": "validation", "annotations": [
            {"segment": top["segment"], "label": top["label"]}]}
    gt_file = str(tmp_path / f"{tag}_gt.json")
    with open(gt_file, "w") as f:
        json.dump(gt, f)
    return output, ev.EpicDetection(gt_file, out).evaluate()


def test_tal_chain_matches_jax(repo_root, tmp_path):
    cfg, jcfg, model, _, _, feats = _models(repo_root, "epic_maps")
    with torch.no_grad():
        preds, _ = model.apply({"video": torch.from_numpy(feats)})
    preds = {k: v.numpy() for k, v in preds.items()}
    got, got_res = _chain(tal_tools, tal_eval, cfg, preds, tmp_path, "port")
    want, want_res = _chain(jax_tal_tools, jax_tal_eval, jcfg, preds,
                            tmp_path, "jax")
    assert got == want
    assert all(len(v) > 0 for v in got["results"].values())
    assert sorted(got_res) == sorted(want_res)
    for group in want_res:
        assert sorted(got_res[group]) == sorted(want_res[group])
        for k, v in want_res[group].items():
            np.testing.assert_array_equal(got_res[group][k], v)
    for group in ("action", "verb", "noun"):
        assert 0.0 < got_res[group]["mAP"] <= 1.0


def test_full_width_config_maps_onto_jax(repo_root):
    """``bmn_epic100.yaml`` at full width (2304 features, ``DIM1D`` 256,
    four groups, ``DSCALE`` 100, maps [97, 300]): the state dict one to
    one with the JAX tree, shape for shape."""
    cfg, jcfg = cfgs(repo_root, BMN)
    module = build_backbone_on_meta(cfg)
    shapes = jax.eval_shape(lambda: jax_build_model(jcfg).init(
        jax.random.PRNGKey(0), {"video": jnp.zeros((1, 100, 2304))}))
    table = jax_table(module)
    sd = module.state_dict()
    assert len(sd) == len(jax.tree_util.tree_leaves(shapes))
    for k, leaf in table.items():
        want = _jax_leaf(shapes, leaf).shape
        perm = ((len(want) - 1, len(want) - 2, *range(len(want) - 2))
                if leaf.layout == "conv" else tuple(reversed(range(len(want)))))
        assert tuple(sd[k].shape) == tuple(want[i] for i in perm), k
    assert module.backbone.conv0.groups == 4
    assert module.head.verb_map_fc.out_features == 97


def test_localization_task_type_is_refused_as_jax(repo_root):
    import importlib.util

    path = os.path.join(repo_root, BMN)
    cfg, jcfg = cfgs(repo_root, BMN)
    spec = importlib.util.spec_from_file_location(
        "jax_run", os.path.join(repo_root, "runs", "run.py"))
    jax_run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_run)
    with pytest.raises(ValueError, match="unknown TASK_TYPE localization"):
        jax_run._prepare_data(jcfg)
    with pytest.raises(ValueError, match="unknown TASK_TYPE localization"):
        run._prepare_data(cfg)
    assert os.path.exists(path)
