"""Checkpoint adaptation, the fine-tune init, ``ValMeter`` and
``flops_count`` of the port: counterparts of ``tests/test_ckpt_preprocess.py``
and of ``tests/test_finetune_chain.py``'s load semantics.

The same arrays go through both packages: the JAX package's flax layouts
((D, H, W, I, O) kernels) are mapped to the port's torch layouts ((O, I,
D, H, W)) through ``models/clip/convert.py``'s layout helpers, and the
reference's ``pos_embd`` keeps its (1, N + 1, C) layout in both. Exact
where both compute the same float32 steps; the grid resize, OpenCV's
in the JAX package and ``F.interpolate`` in the port, within 1e-6."""

import os

import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
import torch.nn as nn

from dist_tpu.config import load_config as jax_load_config
from dist_tpu.tasks.state import TrainState as JaxTrainState
from dist_tpu.utils import checkpoint as jax_cu
from dist_tpu.utils import ckpt_preprocess as jax_pp
from dist_tpu.utils import meters as jax_meters
from dist_tpu_torch.config import load_config
from dist_tpu_torch.models.base.models import VideoModel, build_model
from dist_tpu_torch.models.clip.convert import _conv3d
from dist_tpu_torch.optim.optimizer import construct_optimizer
from dist_tpu_torch.tasks.state import TrainState, create_train_state
from dist_tpu_torch.utils import checkpoint as cu
from dist_tpu_torch.utils import ckpt_preprocess as pp
from dist_tpu_torch.utils import meters
from dist_tpu_torch.utils.misc import flops_count

BASE = "configs/pool/base.yaml"
TINY = "configs/projects/dist/test/tiny_synth.yaml"


def _cfgs(repo_root, frames=8, crop=32, **pre):
    """(port cfg, JAX cfg) of the base schema at a ViT geometry: patch 16,
    tubelet 2."""
    out = []
    for load in (load_config, jax_load_config):
        cfg = load(os.path.join(repo_root, BASE), make_output_dir=False)
        cfg.DATA.NUM_INPUT_FRAMES = frames
        cfg.DATA.TRAIN_CROP_SIZE = crop
        cfg.VIDEO.BACKBONE.PATCH_SIZE = 16
        cfg.VIDEO.BACKBONE.TUBELET_SIZE = 2
        cfg.TRAIN.AUTO_RESUME = False
        for k, v in pre.items():
            setattr(cfg.TRAIN.CHECKPOINT_PRE_PROCESS, k, v)
        out.append(cfg)
    return out


def test_inflate_2d_to_3d_matches_jax():
    """The inflated kernel sums over T to the 2D one (the I3D property)
    and equals the JAX package's, mapped to the torch layout."""
    k2 = np.random.default_rng(0).standard_normal((3, 3, 4, 8)).astype(
        np.float32)
    want = jax_pp.inflate_2d_to_3d(
        {"conv": {"kernel": k2}},
        {"conv": {"kernel": np.zeros((5, 3, 3, 4, 8), np.float32)}})
    got = pp.inflate_2d_to_3d(
        {"conv.weight": torch.from_numpy(np.transpose(k2, (3, 2, 0, 1)))},
        {"conv.weight": torch.zeros(8, 4, 5, 3, 3), "other": torch.ones(2)})
    np.testing.assert_array_equal(got["conv.weight"].numpy(),
                                  _conv3d(want["conv"]["kernel"]))
    np.testing.assert_allclose(got["conv.weight"].sum(2).numpy(),
                               np.transpose(k2, (3, 2, 0, 1)), atol=1e-6)
    assert torch.equal(got["other"], torch.ones(2))   # template kept


def test_pos_embed_repeat_matches_jax(repo_root):
    cfg, jcfg = _cfgs(repo_root, POS_EMBED="repeat")
    pe = np.arange(5 * 4, dtype=np.float32).reshape(1, 5, 4)
    want = jax_pp.preprocess_params(jcfg, {"pos_embd": pe})["pos_embd"]
    got = pp.preprocess_params(cfg, {"backbone.pos_embd":
                                     torch.from_numpy(pe)})
    assert want.shape == (1, 1 + 4 * 4, 4)            # 8 frames / tubelet 2
    np.testing.assert_array_equal(got["backbone.pos_embd"].numpy(), want)


@pytest.mark.parametrize("n_old,crop", [(9, 32), (4, 48), (196, 256)])
def test_pos_embed_super_resolution_matches_jax(repo_root, n_old, crop):
    """Down and up: a 3 x 3 grid to 2 x 2, 2 x 2 to 3 x 3, 14 x 14 to
    16 x 16; the temporal embedding interpolated from 3 to 4 tubelets."""
    cfg, jcfg = _cfgs(repo_root, crop=crop, POS_EMBED="super-resolution")
    rng = np.random.default_rng(n_old)
    pe = rng.standard_normal((1, 1 + n_old, 6)).astype(np.float32)
    te = rng.standard_normal((1, 1 + 3, 6)).astype(np.float32)
    want = jax_pp.preprocess_params(jcfg, {"pos_embd": pe, "temp_embd": te})
    got = pp.preprocess_params(cfg, {"b.pos_embd": torch.from_numpy(pe),
                                     "b.temp_embd": torch.from_numpy(te)})
    side = crop // 16
    assert got["b.pos_embd"].shape == (1, 1 + side * side, 6)
    np.testing.assert_allclose(got["b.pos_embd"].numpy(), want["pos_embd"],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["b.temp_embd"].numpy(),
                               want["temp_embd"].astype(np.float32),
                               atol=1e-7, rtol=0)


@pytest.mark.parametrize("mode", ["central_frame", "average"])
def test_tubelet_init_matches_jax(repo_root, mode):
    cfg, jcfg = _cfgs(repo_root, PATCH_EMBED=mode)
    k = np.random.default_rng(0).standard_normal((1, 16, 16, 3, 8)).astype(
        np.float32)
    want = jax_pp.preprocess_params(
        jcfg, {"stem": {"conv1": {"kernel": k}}})["stem"]["conv1"]["kernel"]
    got = pp.preprocess_params(
        cfg, {"backbone.stem.conv1.weight": torch.from_numpy(_conv3d(k))})
    w = got["backbone.stem.conv1.weight"].numpy()
    assert w.shape == (8, 3, 2, 16, 16)
    np.testing.assert_array_equal(w, _conv3d(want))


class _Vit(nn.Module):
    """A 3D conv, a pos-embed and a head: the parameters the fine-tune
    adaptation touches."""

    def __init__(self, side):
        super().__init__()
        self.conv = nn.Conv3d(4, 8, (5, 3, 3), bias=False)
        self.pos_embd = nn.Parameter(torch.zeros(1, 1 + side * side, 4))
        self.head = nn.Linear(4, 7, bias=False)


def _save_orbax(path, params):
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(path), {"epoch": np.asarray(1, np.int32),
                           "variables": {"params": params}})
    ckptr.wait_until_finished()


def _fine_tune(cfg, module, path):
    state = TrainState(model=VideoModel(module=module, head=None, cfg=cfg),
                       optimizer=None)
    cfg.TRAIN.CHECKPOINT_FILE_PATH = str(path)
    return cu.load_train_checkpoint(cfg, state)


def test_fine_tune_inflates_2d_like_jax(repo_root, tmp_path):
    """``TRAIN.CHECKPOINT_INFLATE`` on the load path: a 2D kernel in the
    file fills the model's 3D conv as the JAX package fills its own."""
    k2 = np.random.default_rng(0).standard_normal((3, 3, 4, 8)).astype(
        np.float32)
    cfg, jcfg = _cfgs(repo_root)
    for c in (cfg, jcfg):
        c.TRAIN.CHECKPOINT_INFLATE = True
    _save_orbax(tmp_path / "ck2d", {"conv": {"kernel": k2}})
    jcfg.TRAIN.CHECKPOINT_FILE_PATH = str(tmp_path / "ck2d")
    jstate = JaxTrainState(
        step=np.zeros((), np.int32), opt_state=(), ema_variables=None,
        variables={"params": {"conv": {"kernel": np.zeros(
            (5, 3, 3, 4, 8), np.float32)}}})
    jstate, _, _ = jax_cu.load_train_checkpoint(jcfg, jstate)
    path = tmp_path / "ck2d.pyth"
    torch.save({"conv.weight": torch.from_numpy(
        np.transpose(k2, (3, 2, 0, 1)))}, path)
    state, start_epoch, start_iter = _fine_tune(cfg, _Vit(2), path)
    assert (start_epoch, start_iter) == (0, 0)
    np.testing.assert_allclose(
        state.model.module.conv.weight.detach().numpy(),
        _conv3d(jstate.variables["params"]["conv"]["kernel"]), atol=1e-7)


def test_fine_tune_adapts_pos_embed_and_pops_head_like_jax(repo_root,
                                                           tmp_path):
    """A checkpoint at another resolution loads through the pos-embed
    resize; FINE_TUNE + POP_HEAD keeps the model's fresh head."""
    rng = np.random.default_rng(0)
    pe_old = rng.standard_normal((1, 1 + 9, 4)).astype(np.float32)
    head_old = rng.standard_normal((7, 4)).astype(np.float32)
    cfg, jcfg = _cfgs(repo_root, ENABLE=True, POS_EMBED="super-resolution",
                      POP_HEAD=True)
    for c in (cfg, jcfg):
        c.TRAIN.FINE_TUNE = True
    _save_orbax(tmp_path / "ckvit", {"backbone": {"pos_embd": pe_old},
                                     "head": {"linear": {"kernel":
                                                         head_old.T}}})
    jcfg.TRAIN.CHECKPOINT_FILE_PATH = str(tmp_path / "ckvit")
    jstate = JaxTrainState(
        step=np.zeros((), np.int32), opt_state=(), ema_variables=None,
        variables={"params": {
            "backbone": {"pos_embd": np.zeros((1, 5, 4), np.float32)},
            "head": {"linear": {"kernel": np.zeros((4, 7), np.float32)}}}})
    jstate, _, _ = jax_cu.load_train_checkpoint(jcfg, jstate)
    path = tmp_path / "ckvit.pyth"
    torch.save({"model_state": {"pos_embd": torch.from_numpy(pe_old),
                                "head.weight": torch.from_numpy(head_old)}},
               path)
    module = _Vit(2)
    fresh_head = module.head.weight.detach().clone()
    state, _, _ = _fine_tune(cfg, module, path)
    np.testing.assert_allclose(
        module.pos_embd.detach().numpy(),
        jstate.variables["params"]["backbone"]["pos_embd"], atol=1e-6)
    assert module.pos_embd.detach()[0, 0].equal(torch.from_numpy(pe_old[0, 0]))
    assert torch.equal(module.head.weight.detach(), fresh_head)


def test_fine_tune_load_semantics(repo_root, tmp_path):
    """The fine-tune entry (``TRAIN.CHECKPOINT_FILE_PATH``, auto-resume
    finding nothing): the weights come from the file, its head entries
    are popped, the epoch resets to 0, the optimizer and the step start
    fresh, and the EMA copy restarts from the loaded weights."""
    cfg = load_config(os.path.join(repo_root, TINY), [
        "OUTPUT_DIR", str(tmp_path / "out"), "TRAIN.AUTO_RESUME", "true",
        "TRAIN.FINE_TUNE", "true", "TRAIN.CHECKPOINT_PRE_PROCESS.ENABLE",
        "true", "TRAIN.CHECKPOINT_PRE_PROCESS.POP_HEAD", "true",
        "MODEL.EMA.ENABLE", "true"])
    src = build_model(cfg, device="cpu", seed=3).module.state_dict()
    path = tmp_path / "pretrained.pyth"
    torch.save({"model_state": {**src, "head.weight": torch.ones(2, 2)}},
               path)
    cfg.TRAIN.CHECKPOINT_FILE_PATH = str(path)
    model = build_model(cfg, device="cpu", seed=0)
    optimizer, _ = construct_optimizer(cfg, model.module, 2)
    state = create_train_state(model, optimizer, 0.9)
    state, start_epoch, start_iter = cu.load_train_checkpoint(cfg, state)
    assert (start_epoch, start_iter, state.step) == (0, 0, 0)
    assert not state.optimizer.state
    got = model.module.state_dict()
    for k, v in src.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
        torch.testing.assert_close(state.ema[k], v, rtol=0, atol=0, msg=k)
    # a fine-tune file that is not a torch checkpoint is refused
    cfg.TRAIN.CHECKPOINT_FILE_PATH = str(tmp_path / "orbax_dir")
    with pytest.raises(NotImplementedError, match="state_dict_from_jax"):
        cu.load_train_checkpoint(cfg, state)


def test_val_meter_matches_jax(repo_root):
    """The same stats through both meters over two eval epochs: the
    valid-count weighting, the minimum errors and the custom stats."""
    path = os.path.join(repo_root, TINY)
    got = meters.ValMeter(3, load_config(path, make_output_dir=False))
    want = jax_meters.ValMeter(3, jax_load_config(path,
                                                  make_output_dir=False))
    rng = np.random.default_rng(4)
    for epoch in range(2):
        for m in (got, want):
            m.reset()
            assert m.log_epoch_stats(epoch) == {}
        for _ in range(3):
            e1, e5, extra = (float(x) * 100 for x in rng.random(3))
            mb = float(rng.integers(1, 9))
            for m in (got, want):
                m.update_stats(e1, e5, mb)
                m.update_custom_stats({"verb_err": extra}, mb_size=mb)
        assert got.log_epoch_stats(epoch) == want.log_epoch_stats(epoch)
    assert (got.min_top1_err, got.min_top5_err) == \
        (want.min_top1_err, want.min_top5_err)


def test_flops_count_of_known_layers():
    """2 per multiply-add: a (3, 8) x (8, 4) product, and a 3 x 3 conv of
    3 -> 5 channels over a 2 x 6 x 6 batch (4 x 4 outputs); ``nan`` where
    counting fails."""
    assert flops_count(nn.Linear(8, 4), torch.zeros(3, 8)) == 2 * 3 * 8 * 4
    conv = nn.Conv2d(3, 5, 3)
    assert flops_count(conv, torch.zeros(2, 3, 6, 6)) == \
        2 * (2 * 5 * 4 * 4) * (3 * 3 * 3)

    def broken(x):
        raise ValueError("no")

    assert np.isnan(flops_count(broken, torch.zeros(1)))
