"""EPIC-KITCHENS' dual verb/noun path of the port against the JAX
package's on the CPU, fp32 (the step float64), on seeded JAX weights brought across by
``models/backbones/convert.py``:

- ``BaseHeadx2`` alone, on a feature map and on a dict, eval and train
  (``atol=2e-4, rtol=1e-4``);
- one step of the port's ``make_train_step`` against the JAX
  ``make_train_step`` with the verb and noun labels, both in float64 (the
  JAX package under ``jax.enable_x64``, the port's module cast to
  float64), on a tiny ir-CSN (``csn_ek100.yaml``, DEPTH 10) with
  ``BaseHeadx2`` and on the tiny SlowFast of
  ``tests/test_torch_port_slowfast.py`` with ``SlowFastHeadx2``: the loss
  and its per-head parts (``LOSS_RTOL``), the joint action and per-head
  errors (equal), every gradient (the JAX step's gradients are read off
  an optimizer that keeps them, each leaf within ``GRAD_TOL`` of its
  largest entry) and every updated running stat (``STATS_TOL``); with
  mixup and cutmix on, the CSN step mixes nothing in both packages (and
  with the two class counts both refuse to build a mixup at all);
- dict predictions without verb and noun labels count errors of 0;
- ``train_epoch`` carries ``label_verb`` and ``label_noun`` to the step;
- the serving engine refuses a dual head at construction, as the JAX
  package's does."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from dist_tpu.models.base import models as jm
from dist_tpu.tasks import state as jstate
from dist_tpu_torch.models.base import models as pm
from dist_tpu_torch.models.backbones.convert import state_dict_from_jax
from dist_tpu_torch.optim.optimizer import construct_optimizer
from dist_tpu_torch.tasks import state as pstate
from dist_tpu_torch.tasks.state import _prep_video
from tests.test_torch_port_resnet3d import (
    TOL,
    assert_tree_maps_one_to_one,
    cfgs,
    jax_variables,
    load_jax,
)
from tests.test_torch_port_slowfast import SF, TINY, head_opts, tiny_model
from tests.test_torch_port_tada import _stats

CSN = "configs/projects/tada/csn_ek100.yaml"
CSN_TINY = ["VIDEO.BACKBONE.DEPTH", "10",
            "VIDEO.BACKBONE.NUM_FILTERS", "[8, 16, 32, 64, 128]",
            "DATA.NUM_INPUT_FRAMES", "8", "DATA.TRAIN_CROP_SIZE", "64",
            "DATA.TEST_CROP_SIZE", "64", "VIDEO.HEAD.DROPOUT_RATE", "0.0",
            "LOG_MODEL_INFO", "false"]
STEP = ["OPTIMIZER.WARMUP_EPOCHS", "0"]
MIXUP = ["AUGMENTATION.MIXUP.ENABLE", "true",
         "AUGMENTATION.CUTMIX.ENABLE", "true"]
# The step in float64: in fp32 these random nets' gradients carry the
# rounding of the forward grown with depth, and a leaf whose gradient
# cancels (a 1-channel bottleneck's BatchNorm scale) reads 10-30 % of its
# largest entry apart between the packages, whatever the fast pathway's
# width. In float64 the running stats agree within 5e-14 of their
# largest; the loss reads 1.4e-7 apart and the worst gradient leaf 8.3e-7
# of its largest entry, since the JAX package pools the head's input and
# takes the loss in fp32. The limits: 7 to 20 times these.
GRAD_TOL = 1e-5
STATS_TOL = dict(rtol=1e-12, atol=1e-12)
LOSS_RTOL = 1e-6
CASES = {"csn": (CSN, CSN_TINY + head_opts("BaseHeadx2", "[5, 7]") + STEP),
         "csn-mixup": (CSN, CSN_TINY + head_opts("BaseHeadx2", "[5, 7]")
                       + STEP),
         "slowfast": (SF, TINY + head_opts("SlowFastHeadx2", "[5, 7]")
                      + STEP)}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("as_dict", [False, True], ids=["map", "dict"])
def test_base_headx2_matches_jax(train, as_dict):
    rng = np.random.default_rng(50)
    x = rng.standard_normal((3, 2, 2, 2, 16)).astype(np.float32)
    jhead = jm.BaseHeadx2(num_classes=(5, 7))
    variables = jax_variables(jhead, 51, jnp.asarray(x), train=False)
    with torch.device("meta"):
        head = pm.BaseHeadx2(16, (5, 7))
    head = load_jax(head.to_empty(device="cpu"), variables).train(train)
    jx = {"features": jnp.asarray(x)} if as_dict else jnp.asarray(x)
    want, wfeat = jhead.apply(variables, jx, train=train)
    px = torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 4, 1, 2, 3))))
    with torch.no_grad():
        got, feat = head({"features": px} if as_dict else px)
    assert set(got) == set(want) == {"verb_class", "noun_class"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_allclose(feat.numpy(), np.asarray(wfeat), **TOL)
    if not train:
        np.testing.assert_allclose(got["verb_class"].sum(-1).numpy(), 1.0,
                                   rtol=1e-6)


def _keep_grads():
    """An optax transform that applies no update and keeps the gradients
    as its state: the JAX step's gradients, read off its new state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


@pytest.fixture(scope="module")
def clips():
    return np.random.default_rng(52).integers(0, 256, (2, 8, 64, 64, 3),
                                              dtype=np.uint8)


@pytest.mark.parametrize("case", list(CASES))
def test_dual_label_step_matches_jax(repo_root, clips, case):
    path, opts = CASES[case]
    cfg, jcfg, jmodel, variables, model = tiny_model(repo_root, path, opts,
                                                     clips, 53)
    verbs, nouns = np.array([1, 4], np.int32), np.array([6, 2], np.int32)
    # the clips normalised once, in float64: both steps pass a float video
    video = _prep_video(cfg, torch.from_numpy(clips)).double().numpy()
    batch = {"video": video, "labels": verbs, "label_verb": verbs,
             "label_noun": nouns}
    step_cfg, jstep_cfg = cfg, jcfg
    if case == "csn-mixup":
        # with the list of class counts both packages' MixupConfig stops
        # at int(NUM_CLASSES) (test_mixup_on_an_epic_config_fails_alike);
        # the steps get one count to build their mixup, the model keeps
        # its two heads: the dict target then skips the mixup
        step_cfg, jstep_cfg = cfgs(repo_root, path, opts + MIXUP + [
            "VIDEO.HEAD.NUM_CLASSES", "5"])
    with jax.enable_x64(True):
        jstep = jax.jit(jstate.make_train_step(
            jmodel, jstep_cfg, _keep_grads(), lambda step: 0.1))
        wide = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)
        jnew, want = jstep(jstate.create_train_state(wide, _keep_grads()),
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(0))
        jnew, want = jax.device_get((jnew, want))
    assert jax.tree_util.tree_leaves(jnew.opt_state)[0].dtype == np.float64
    jgrads = state_dict_from_jax(jnew.opt_state, model.module)
    after = state_dict_from_jax(jnew.variables, model.module)

    def port_step(port_cfg):
        load_jax(model.module, variables)
        model.module.double()
        optimizer, lr_fn = construct_optimizer(port_cfg, model.module, 4)
        metrics = pstate.make_train_step(model, port_cfg, optimizer, lr_fn)(
            pstate.create_train_state(model, optimizer),
            {k: torch.from_numpy(v).long() if k != "video"
             else torch.from_numpy(v) for k, v in batch.items()})
        return {k: float(v) for k, v in metrics.items()}

    got = port_step(step_cfg)
    assert set(got) - {"lr"} == set(want) - {"lr"}
    assert {"loss_verb_class", "loss_noun_class", "top1_err_verb",
            "top5_err_noun"} <= set(got)
    for k in want:
        if k.startswith("loss"):
            assert got[k] == pytest.approx(float(want[k]), rel=LOSS_RTOL), k
        elif k != "lr":
            assert got[k] == pytest.approx(float(want[k]), abs=1e-4), k
    assert 0 < got["loss_verb_class"] < got["loss"]
    for k, p in model.module.named_parameters():
        g, w = p.grad.numpy(), np.asarray(jgrads[k])
        assert g.dtype == w.dtype == np.float64, k
        scale = float(np.abs(w).max())
        assert scale > 0, k
        np.testing.assert_allclose(g, w, atol=GRAD_TOL * scale, rtol=0,
                                   err_msg=k)
    for k, v in _stats(model.module.state_dict()).items():
        np.testing.assert_allclose(v.numpy(), after[k], err_msg=k,
                                   **STATS_TOL)
    if case == "csn-mixup":
        # mixup and cutmix on, and nothing mixed: the step without them
        assert port_step(cfg)["loss"] == got["loss"]


def test_mixup_on_an_epic_config_fails_alike(repo_root):
    """Mixup or cutmix on with the verb/noun class counts: both packages'
    train steps stop at construction, in ``MixupConfig.from_cfg``'s
    ``int(NUM_CLASSES)`` (no shipped EPIC config turns mixup on)."""
    cfg, jcfg = cfgs(repo_root, CSN, CSN_TINY + head_opts(
        "BaseHeadx2", "[5, 7]") + MIXUP)
    model = pm.build_model(cfg, device="cpu")
    optimizer, lr_fn = construct_optimizer(cfg, model.module, 4)
    with pytest.raises(TypeError, match="int()"):
        pstate.make_train_step(model, cfg, optimizer, lr_fn)
    with pytest.raises(TypeError, match="int()"):
        jstate.make_train_step(jm.build_model(jcfg), jcfg, optax.sgd(0.1),
                               lambda step: 0.1)


def test_dict_preds_without_epic_labels_count_no_error(repo_root,
                                                       monkeypatch):
    """Dict predictions and no verb/noun labels (a loss that takes them
    as they are): the step's errors are 0, as in the JAX step."""
    cfg, _ = cfgs(repo_root, CSN, CSN_TINY + head_opts("BaseHeadx2", "[5, 7]")
                  + ["DATA.TRAIN_CROP_SIZE", "32"])
    model = pm.build_model(cfg, device="cpu")
    monkeypatch.setattr(pstate, "calculate_loss", lambda cfg, preds, *_, **__: (
        sum(p.float().mean() for p in preds.values()), {}))
    optimizer, lr_fn = construct_optimizer(cfg, model.module, 4)
    metrics = pstate.make_train_step(model, cfg, optimizer, lr_fn)(
        pstate.create_train_state(model, optimizer),
        {"video": torch.zeros((2, 8, 32, 32, 3), dtype=torch.uint8),
         "labels": torch.tensor([1, 2])})
    assert float(metrics["top1_err"]) == float(metrics["top5_err"]) == 0.0
    assert not any(k.endswith(("_verb", "_noun")) for k in metrics)


def test_train_epoch_carries_the_verb_and_noun_labels(repo_root, caplog):
    """Each host batch's ``label_verb`` and ``label_noun`` reach the step
    as long tensors on the model's device, beside the video and label;
    the per-head errors reach the meter."""
    import logging
    import types

    from dist_tpu_torch.tasks.train import train_epoch
    from dist_tpu_torch.utils import meters

    cfg, _ = cfgs(repo_root, CSN, ["LOG_PERIOD", "1"])
    rng = np.random.default_rng(54)
    batches = [{"video": rng.integers(0, 256, (2, 4, 8, 8, 3), np.uint8),
                "label": np.array([i, i + 1]),
                "label_verb": np.array([i, i + 1]),
                "label_noun": np.array([10 + i, 20 + i])} for i in range(2)]
    seen = []

    def step(state, batch):
        seen.append(batch)
        state.step += 1
        return {"loss": torch.tensor(1.0), "top1_err": torch.tensor(50.0),
                "top5_err": torch.tensor(0.0), "lr": torch.tensor(0.1),
                "top1_err_verb": torch.tensor(25.0)}

    state = types.SimpleNamespace(step=0, model=types.SimpleNamespace(
        device=torch.device("cpu")))
    with caplog.at_level(logging.INFO, logger="dist_tpu_torch"):
        train_epoch(cfg, state, step, batches, meters.TrainMeter(2, cfg), 0)
    lines = [r.getMessage() for r in caplog.records
             if '"train_iter"' in r.getMessage()]
    assert len(lines) == 2 and all('"top1_err_verb": 25.0' in ln
                                   for ln in lines)
    assert len(seen) == 2
    for host, dev in zip(batches, seen):
        assert set(dev) == {"video", "labels", "label_verb", "label_noun"}
        for key in ("label_verb", "label_noun"):
            assert dev[key].dtype == torch.long
            np.testing.assert_array_equal(dev[key].numpy(), host[key])


def test_engine_refuses_a_dual_head_as_jax(repo_root):
    """The JAX engine asserts a single-label head at construction; the
    port raises ``NotImplementedError`` there and names where a dual
    head is evaluated and scored for a results file."""
    from dist_tpu.serving.engine import InferenceEngine as JaxEngine
    from dist_tpu_torch.serving.engine import InferenceEngine

    cfg, jcfg = cfgs(repo_root, CSN, CSN_TINY)
    with pytest.raises(AssertionError, match="single-label heads"):
        JaxEngine(jcfg, batch_size=2)
    with pytest.raises(NotImplementedError,
                       match="single-label heads.*eval step and the test task"
                       ".*the submission task"):
        InferenceEngine(cfg, batch_size=2, device="cpu")


def test_csn_ek100_full_width_maps_onto_jax_and_builds(repo_root):
    """ir-CSN-152 with ``BaseHeadx2`` [97, 300] at full width (16 frames
    at 224^2): 29.70 M weights one to one with the JAX tree; it builds on
    the CPU, its head over 2048 features."""
    _, n = assert_tree_maps_one_to_one(repo_root, CSN, 16, 224)
    assert 29.6e6 < n < 29.8e6
    cfg, _ = cfgs(repo_root, CSN)
    model = pm.build_model(cfg, device="cpu")
    head = model.module.head
    assert isinstance(head, pm.BaseHeadx2) and model.head is None
    assert (head.out1.in_features, head.out1.out_features,
            head.out2.out_features) == (2048, 97, 300)
    assert head.dropout_rate == 0.5
