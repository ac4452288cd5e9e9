"""The port's contrastive heads (``dist_tpu_torch/models/heads/
contrastive.py``) and SSL losses (``dist_tpu_torch/optim/contrastive.py``,
``optim/losses.py::calculate_loss``) against the JAX package's, fp32 on
the CPU:

- ``ContrastiveHead`` (with and without ``FINAL_BN``),
  ``ContrastiveHeadTopicPred`` and ``ContrastiveHeadTopicPredPlusPlus``
  on seeded JAX weights carried across by
  ``models/backbones/convert.py`` (its ``head`` and ``head_stats``), in
  eval and in train mode: both outputs at ``TOL`` and the running stats
  after a train forward (flax's decay 0.99) at ``STATS_TOL``;
- the four SSL losses through ``calculate_loss`` (``PRETRAIN.LOSS`` of
  each pretrain config, and SimCLR's variants: no "one" term, MIL
  positives, the parabola similarities, two losses joined by ``+``): the
  loss and every part at ``rtol=1e-5``, the gradients with respect to
  the embeddings and the topical map within 1e-5 of their largest entry;
- at world 2 (two gloo ranks), the head and the loss on each rank's half
  of the videos against one process on the whole batch: the loss
  (``rtol=1e-5``), the mean of the ranks' head gradients and each rank's
  feature gradient over the world size (within 1e-5 of the largest
  entry; a bias that a BatchNorm follows has a gradient of 0 up to
  rounding, below ``ZERO_GRAD`` on both sides), the running stats
  (``STATS_TOL``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dist_tpu.optim  # noqa: F401  (registers the JAX SSL losses)
from dist_tpu.models.base.bn import set_bn_frozen
from dist_tpu.models.heads import contrastive as jh
from dist_tpu.optim.losses import calculate_loss as jax_loss
from dist_tpu_torch.models.base.models import build_head
from dist_tpu_torch.optim.losses import calculate_loss
from dist_tpu_torch.parallel import launch
from tests import torch_ddp_ranks
from tests.test_torch_port_resnet3d import cfgs, jax_variables, load_jax

TOL = dict(atol=2e-5, rtol=1e-5)
STATS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = 1e-5
# a gradient whose largest entry is below this is 0 up to rounding (a bias
# that a BatchNorm follows)
ZERO_GRAD = 1e-6
LOSS_RTOL = 1e-5
SPAWN_TIMEOUT_S = 240
SIMCLR = "configs/projects/hico/simclr_k400_s3dg.yaml"
HICO = "configs/projects/hico/pt-k400/s3dg-hico-l.yaml"
HICO_PP = "configs/projects/hico++/pt-k400/s3dg-hico++m6.yaml"
HICO_PP_VIT = "configs/projects/hico++/pt-k400f/vit-s-hico++m6.yaml"
SMALL = ["PRETRAIN.CONTRASTIVE.HEAD_MID_DIM", "24",
         "PRETRAIN.CONTRASTIVE.HEAD_OUT_DIM", "12"]
DIM_IN = 16
HEADS = {
    "ContrastiveHead": (SIMCLR, [], 2),
    "ContrastiveHead-final_bn": (SIMCLR, ["PRETRAIN.CONTRASTIVE.FINAL_BN",
                                          "true"], 2),
    "ContrastiveHeadTopicPred": (HICO, [], 3),
    "ContrastiveHeadTopicPredPlusPlus": (HICO_PP, [], 4),
}
LOSSES = {
    "Contrastive": (SIMCLR, [], 2, None),
    "Contrastive-3views": (SIMCLR, ["PRETRAIN.NUM_CLIPS_PER_VIDEO", "3"], 3,
                           None),
    "Contrastive-no_one": (SIMCLR, ["PRETRAIN.CONTRASTIVE.WITH_ONE", "false"],
                           2, None),
    "Contrastive-mil": (SIMCLR, ["PRETRAIN.CONTRASTIVE.INS_MIL", "true",
                                 "PRETRAIN.NUM_CLIPS_PER_VIDEO", "3"], 3,
                        None),
    "Contrastive-parabola": (SIMCLR, ["PRETRAIN.CONTRASTIVE.SIM_FUNC_POS",
                                      "parabola",
                                      "PRETRAIN.CONTRASTIVE.SIM_FUNC_NEG",
                                      "parabola"], 2, None),
    "HiCo": (HICO, [], 3, "full"),
    "HiCoPlusPlus": (HICO_PP, ["PRETRAIN.NUM_CLIPS_PER_VIDEO", "4"], 4,
                     "pairs"),
    "HiCoPlusPlusVit": (HICO_PP_VIT, ["PRETRAIN.NUM_CLIPS_PER_VIDEO", "4"], 4,
                        "pairs"),
    "Contrastive+HiCo": (HICO, ["PRETRAIN.LOSS", "Contrastive+HiCo",
                                "PRETRAIN.LOSS_WEIGHTS", "[0.5, 2.0]"], 3,
                         "full"),
}
VIDEOS = 4


def _head_cfgs(repo_root, path, opts):
    cfg, jcfg = cfgs(repo_root, path, SMALL + list(opts))
    return cfg, jcfg


def _stats(sd):
    return {k: v.numpy() for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def _port_head(cfg, variables):
    with torch.device("meta"):
        head = build_head(cfg, DIM_IN)
    return load_jax(head.to_empty(device="cpu"), variables)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(HEADS))
def test_contrastive_heads_match_jax(repo_root, name, train):
    path, opts, views = HEADS[name]
    cfg, jcfg = _head_cfgs(repo_root, path, opts)
    n = VIDEOS * views
    rng = np.random.default_rng(70 + len(name))
    # ContrastiveHead pools a feature map (N, T, H, W, C); the others take
    # pooled features
    shape = (n, 2, 3, 3, DIM_IN) if name.startswith("ContrastiveHead-") or \
        name == "ContrastiveHead" else (n, DIM_IN)
    x = rng.standard_normal(shape).astype(np.float32)
    jhead = getattr(jh, name.split("-")[0])(jcfg)
    variables = jax_variables(jhead, 71, jnp.asarray(x), train=False)
    head = _port_head(cfg, variables).train(train)
    set_bn_frozen(False)
    if train:
        (want, wemb), new = jhead.apply(variables, jnp.asarray(x), train=True,
                                        mutable=["batch_stats"])
    else:
        want, wemb = jhead.apply(variables, jnp.asarray(x), train=False)
    px = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(x, -1, 1) if x.ndim == 5 else x))
    with torch.no_grad():
        got, emb = head(px)
    np.testing.assert_allclose(emb.numpy(), np.asarray(wemb), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(np.linalg.norm(emb.numpy(), axis=1), 1.0,
                               rtol=1e-5)
    if name.startswith("ContrastiveHeadTopicPred"):
        m = n // 2 if name.endswith("PlusPlus") else n
        assert got.shape == (m, m, 2)
        # the map is symmetric: (i, j) scores [z_i, z_j] and [z_j, z_i]
        np.testing.assert_allclose(got[..., 0].numpy(),
                                   got.transpose(0, 1)[..., 1].numpy(),
                                   rtol=1e-6, atol=1e-6)
    if train:
        want_stats = _stats({k: torch.from_numpy(v) for k, v in
                             _sd(head, {**variables, **new}).items()})
        got_stats = _stats(head.state_dict())
        before = _stats({k: torch.from_numpy(v) for k, v in
                         _sd(head, variables).items()})
        assert got_stats and set(got_stats) == set(want_stats)
        for k in got_stats:
            assert not np.allclose(got_stats[k], before[k]), k
            np.testing.assert_allclose(got_stats[k], want_stats[k],
                                       err_msg=k, **STATS_TOL)


def _sd(module, variables):
    from dist_tpu_torch.models.backbones.convert import state_dict_from_jax

    return state_dict_from_jax(variables, module)


def _loss_inputs(name, views, d=12, seed=80):
    rng = np.random.default_rng(seed)
    n = VIDEOS * views
    z = rng.standard_normal((n, d)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    kind = LOSSES[name][3]
    m = n // 2 if kind == "pairs" else n
    preds = (rng.standard_normal((m, m, 2)).astype(np.float32)
             if kind else z[:, :3].copy())
    return z, preds


@pytest.mark.parametrize("name", list(LOSSES))
def test_ssl_losses_and_gradients_match_jax(repo_root, name):
    path, opts, views, _ = LOSSES[name]
    cfg, jcfg = cfgs(repo_root, path, opts)
    z, preds = _loss_inputs(name, views)
    contrastive = np.tile(np.arange(views), (VIDEOS, 1))

    def jfn(zz, pp):
        loss, parts = jax_loss(jcfg, pp, zz, {"self-supervised": {
            "contrastive": jnp.asarray(contrastive)}})
        return loss, parts

    (wloss, wparts), (wgz, wgp) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(jnp.asarray(z),
                                            jnp.asarray(preds))
    tz = torch.from_numpy(z).requires_grad_(True)
    tp = torch.from_numpy(preds).requires_grad_(True)
    loss, parts = calculate_loss(cfg, tp, tz, {"self-supervised": {
        "contrastive": torch.from_numpy(contrastive)}})
    loss.backward()
    assert loss.item() == pytest.approx(float(wloss), rel=LOSS_RTOL)
    assert set(parts) == set(wparts)
    for k in wparts:
        assert float(parts[k]) == pytest.approx(float(wparts[k]),
                                                rel=LOSS_RTOL), k
    for got, want in ((tz.grad, wgz), (tp.grad, wgp)):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        if LOSSES[name][3] is None and got is tp.grad:
            assert got is None or float(got.abs().max()) == 0.0
            continue
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * scale)


def test_ssl_loss_names_what_it_lacks(repo_root):
    cfg, _ = cfgs(repo_root, SIMCLR, ["PRETRAIN.LOSS", "Nope"])
    z, preds = _loss_inputs("Contrastive", 2)
    with pytest.raises(KeyError, match="Loss_Nope"):
        calculate_loss(cfg, torch.from_numpy(preds), torch.from_numpy(z),
                       {"self-supervised": {"contrastive": torch.zeros(4, 2)}})


WORLD2 = {"Contrastive": (SIMCLR, 2), "HiCo": (HICO, 3),
          "HiCoPlusPlusVit": (HICO_PP_VIT, 4)}


def test_gather_at_world_2_equals_one_process(repo_root):
    cases = []
    for i, (name, (path, views)) in enumerate(WORLD2.items()):
        opts = (SMALL + ["TPU.MESH.DATA", "2", "PRETRAIN.NUM_CLIPS_PER_VIDEO",
                         str(views)])
        cfg, jcfg = cfgs(repo_root, path, opts)
        rng = np.random.default_rng(90 + i)
        feats = rng.standard_normal((VIDEOS * views, DIM_IN)) \
            .astype(np.float32)
        jhead = getattr(jh, str(jcfg.VIDEO.HEAD.NAME))(jcfg)
        variables = jax_variables(jhead, 91 + i, jnp.asarray(feats),
                                  train=False)
        weights = {k: v.numpy().copy() for k, v in
                   _port_head(cfg, variables).state_dict().items()}
        cases.append((cfg, weights, feats, views))
    ranks = launch.launch_task(cases[0][0], torch_ddp_ranks.ssl_head_and_loss,
                               (cases,), device="cpu",
                               timeout=SPAWN_TIMEOUT_S)
    whole = torch_ddp_ranks.ssl_head_and_loss(cases)
    assert len(ranks) == 2
    for i, name in enumerate(WORLD2):
        one = whole[i]
        for r in ranks:
            assert r[i]["loss"] == pytest.approx(one["loss"], rel=LOSS_RTOL), \
                name
            for k, v in one["stats"].items():
                np.testing.assert_allclose(r[i]["stats"][k], v,
                                           err_msg=f"{name} {k}", **STATS_TOL)
        for k, want in one["grads"].items():
            got = (ranks[0][i]["grads"][k] + ranks[1][i]["grads"][k]) / 2
            scale = float(np.abs(want).max())
            if scale < ZERO_GRAD:
                # a bias before a BatchNorm: 0 up to rounding on both sides
                assert float(np.abs(got).max()) < ZERO_GRAD, (name, k)
                continue
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=GRAD_TOL * scale,
                                       err_msg=f"{name} {k}")
        feat = np.concatenate([r[i]["feature_grad"] for r in ranks]) / 2
        want = one["feature_grad"]
        np.testing.assert_allclose(feat, want, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(want).max()),
                                   err_msg=name)
