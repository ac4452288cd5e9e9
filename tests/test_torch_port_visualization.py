"""The port's feature-map visualization (``utils/visualization.py``,
``VideoModel.forward_with_intermediates``, ``tools/visualize_features.py``)
against the JAX package's (``dist_tpu/utils/visualization.py``,
``VideoModel.apply_with_intermediates``) on the CPU.

- ``feature_map_image`` on the same seeded array (given as numpy and as
  a tensor), uint8 for uint8; the gate; ``_iter_feature_maps`` on a
  tree with tuples, dicts and lists.
- The captured maps of a tiny DiST (``tiny_synth.yaml``), a tiny TAda2D
  and a tiny SlowFast (the geometries of ``test_torch_port_tada.py`` and
  ``_slowfast.py``) against JAX's with converted weights: the same names
  and shapes, each map within ``MAP_TOL``, each image equal at
  ``IMAGE_EQUAL`` of its pixels and within 1 elsewhere (``astype(uint8)``
  truncates at multiples of 1/255, where fp32 rounding in another order
  may fall either side); the predictions those of a plain forward, bit
  for bit.
- ``dump_feature_maps`` writes JAX's directory listing, and on JAX's own
  maps JAX's bytes (its ``cv2.imwrite``).
- TAda2D-R50 at full depth (narrow widths, 4 frames of 32^2: the names
  do not depend on widths) names the 261 maps of
  ``tests/tada2d_8x8_feature_maps.txt`` in both packages, the list that
  ``chip_smoke.py`` holds the full-width run on the card to.
- The test task with ``VISUALIZATION.ENABLE`` and the tool write the
  files."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dist_tpu.config import load_config as jax_load_config
from dist_tpu.models.base.models import build_model as jax_build_model
from dist_tpu.utils import visualization as jvis
from dist_tpu_torch.config import load_config
from dist_tpu_torch.models.base.models import build_model
from dist_tpu_torch.models.clip.convert import state_dict_from_jax
from dist_tpu_torch.tasks import test as port_test
from dist_tpu_torch.tasks.state import _prep_video
from dist_tpu_torch.tools import visualize_features
from dist_tpu_torch.utils import visualization as pvis
from tests.test_torch_port_ddp import STEP, TINY, _step_inputs
from tests.test_torch_port_slowfast import SF, head_opts, tiny_model
from tests.test_torch_port_slowfast import TINY as SF_TINY
from tests.test_torch_port_tada import TADA
from tests.test_torch_port_tada import TINY as TADA_TINY

# fp32 in another order (JAX's capture jitted): each captured map
# against JAX's, of its largest value (the CPU reads at most 1.5e-6 on
# the tiny DiST, 6.2e-5 on TAda2D, 4.8e-4 on SlowFast: 16 blocks of
# rounding; test_torch_port_slowfast.py's FEAT_TOL)
MAP_TOL = 1e-3
# the share of a model's image pixels that must be equal (the others
# within 1): the CPU reads 100 % on the tiny DiST, 99.992 % on TAda2D,
# 99.956 % on SlowFast
IMAGE_EQUAL = 0.999
# TAda2D-R50 at full depth with narrow widths: the names of the full
# model's maps
TADA50 = ["VIDEO.BACKBONE.NUM_FILTERS", "[8, 32, 64, 128, 256]",
          "DATA.NUM_INPUT_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32",
          "DATA.TEST_CROP_SIZE", "32"]
TADA_NAMES = os.path.join(os.path.dirname(__file__),
                          "tada2d_8x8_feature_maps.txt")
VIS = ["VISUALIZATION.ENABLE", "true",
       "VISUALIZATION.FEATURE_MAPS.ENABLE", "true"]


def _maps(tree):
    return {name: np.asarray(a) for name, a in
            (jvis._iter_feature_maps(tree) if not _is_port(tree)
             else pvis._iter_feature_maps(tree))}


def _is_port(tree):
    return any(torch.is_tensor(v) for vs in tree.values()
               for v in (vs if isinstance(vs, tuple) else (vs,)))


def _dist():
    """(port cfg, JAX model, JAX variables, port model, normalized
    video, text features) of the tiny DiST with converted weights."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jcfg, params, batch = _step_inputs(repo)
    cfg = load_config(os.path.join(repo, TINY), STEP, make_output_dir=False)
    model = build_model(cfg, device="cpu")
    model.module.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v
                                  in state_dict_from_jax(params).items()})
    video = _prep_video(cfg, torch.from_numpy(batch["video"][:2]))
    return (cfg, jax_build_model(jcfg), {"params": params}, model, video,
            batch["text_features"])


def _conv(path, opts, shape, seed):
    """The same for a conv-family model with seeded JAX variables, its
    running stats calibrated on the clips (``test_torch_port_slowfast.py::
    tiny_model``: a deep random model stays in range)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    clips = np.random.default_rng(seed).integers(0, 256, shape,
                                                 dtype=np.uint8)
    cfg, _, jmodel, variables, model = tiny_model(repo, path, opts, clips,
                                                  seed)
    return (cfg, jmodel, variables, model,
            _prep_video(cfg, torch.from_numpy(clips)), None)


MODELS = {
    "dist": _dist,
    "tada2d": lambda: _conv(TADA, TADA_TINY, (2, 4, 32, 32, 3), 4),
    "slowfast": lambda: _conv(SF, SF_TINY + head_opts("SlowFastHead", "7"),
                              (1, 8, 64, 64, 3), 2),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def captured(request):
    """Both packages' captures of one model, and the port's plain
    predictions."""
    cfg, jmodel, variables, model, video, text = MODELS[request.param]()
    inputs = {"video": jnp.asarray(video.numpy())}
    if text is not None:
        inputs["text_features"] = jnp.asarray(text)
    jpreds, jinter = jax.jit(lambda v, x: jmodel.apply_with_intermediates(
        v, x))(variables, inputs)
    tf = None if text is None else torch.from_numpy(text)
    preds, inter = model.forward_with_intermediates(video, tf)
    with torch.no_grad():
        plain, _ = model.apply({"video": video, "text_features": tf},
                               train=False)
    return {"name": request.param, "cfg": cfg, "jax": jax.device_get(jinter),
            "jax_preds": jpreds, "port": inter, "preds": preds,
            "plain": plain}


def test_feature_map_image_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 4, 6)).astype(np.float32)
    x[0, 1, 2, 3] = 0.5       # a constant pixel: the 1e-8 floor
    want = jvis.feature_map_image(x)
    assert want.dtype == np.uint8 and want.shape == (2, 6 * 5, 3 * 4)
    for given in (x, torch.from_numpy(x)):
        got = pvis.feature_map_image(given)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("vis,maps,want", [
    (False, True, False), (True, False, False), (True, True, True)])
def test_the_gate_matches_jax(repo_root, vis, maps, want):
    opts = ["VISUALIZATION.ENABLE", str(vis).lower(),
            "VISUALIZATION.FEATURE_MAPS.ENABLE", str(maps).lower()]
    path = os.path.join(repo_root, TINY)
    cfg = load_config(path, opts, make_output_dir=False)
    jcfg = jax_load_config(path, opts, make_output_dir=False)
    assert pvis.visualization_enabled(cfg) == \
        jvis.visualization_enabled(jcfg) == want


def test_iter_feature_maps_matches_jax():
    rng = np.random.default_rng(1)

    def five(*lead):
        return rng.standard_normal(lead + (2, 2, 2, 3)).astype(np.float32)

    tree = {"__call__": (five(1),),
            "stem": {"__call__": (five(1), five(2))},
            "fuse": {"__call__": ((five(1), five(1)),),
                     "bn": {"__call__": [five(2)]}},
            "flat": {"__call__": (np.zeros((2, 3)),)},
            "scan": {"__call__": (rng.standard_normal((2, 1, 2, 2, 2, 3)),)},
            "heads": {"__call__": ({"slow": five(1), "fast": five(1)},)}}
    want = list(jvis._iter_feature_maps(tree))
    got = list(pvis._iter_feature_maps(tree))
    assert [n for n, _ in got] == [n for n, _ in want] == [
        "output", "stem.0", "stem.1", "fuse.0", "fuse.1", "fuse.bn",
        "heads.slow", "heads.fast"]
    for (_, a), (_, b) in zip(got, want):
        assert a is b


def test_captured_maps_match_jax(captured):
    """The same maps under the same names, each within ``MAP_TOL``; the
    flagship's side network dumps its temporal stem alone."""
    want, got = _maps(captured["jax"]), _maps(captured["port"])
    assert sorted(got) == sorted(want)
    if captured["name"] == "dist":
        assert list(got) == ["dist_net.temporal_stem"]
    else:
        assert len(got) > 100
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, err_msg=name,
                                   atol=MAP_TOL * float(np.abs(w).max()))


def test_captured_images_match_jax(captured):
    """Every image within 1 of JAX's, and equal at ``IMAGE_EQUAL`` of the
    model's pixels."""
    want, got = _maps(captured["jax"]), _maps(captured["port"])
    equal = total = 0
    for name, w in want.items():
        a = pvis.feature_map_image(torch.from_numpy(got[name])).numpy()
        b = jvis.feature_map_image(w)
        diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert diff.max() <= 1, name
        equal += int((diff == 0).sum())
        total += diff.size
    assert equal / total >= IMAGE_EQUAL, equal / total


def test_capture_keeps_the_predictions(captured):
    """The hooks only read: the captured forward's predictions are a
    plain forward's, bit for bit, and JAX's within ``MAP_TOL``."""
    preds, plain = captured["preds"], captured["plain"]
    if isinstance(preds, dict):
        for k in preds:
            assert torch.equal(preds[k], plain[k]), k
        return
    assert torch.equal(preds, plain)
    want = np.asarray(captured["jax_preds"])
    np.testing.assert_allclose(preds.numpy(), want, rtol=0,
                               atol=MAP_TOL * float(np.abs(want).max()))


def test_dump_writes_jax_listing_and_bytes(captured, tmp_path):
    """The directory listing of the port's dump of its own maps is JAX's
    of its maps; the port's files of JAX's maps are JAX's
    ``cv2.imwrite`` bytes."""
    pytest.importorskip("cv2")
    cfg = captured["cfg"]
    listings = {}
    for who, maps, dump in (("jax", captured["jax"], jvis.dump_feature_maps),
                            ("port", captured["port"],
                             pvis.dump_feature_maps),
                            ("port_of_jax", captured["jax"],
                             pvis.dump_feature_maps)):
        cfg.OUTPUT_DIR = str(tmp_path / who)
        n = dump(cfg, maps)
        root = tmp_path / who / "features"
        listings[who] = sorted(str(p.relative_to(root))
                               for p in root.rglob("*.jpg"))
        assert n == len(listings[who]) > 0
    assert listings["port"] == listings["jax"] == listings["port_of_jax"]
    for rel in listings["jax"]:
        a = (tmp_path / "jax" / "features" / rel).read_bytes()
        b = (tmp_path / "port_of_jax" / "features" / rel).read_bytes()
        assert a == b, rel


def test_full_depth_tada2d_names(repo_root):
    """TAda2D-R50 8x8's 261 maps, named alike in both packages and as the
    committed list names them."""
    path = os.path.join(repo_root, TADA)
    jcfg = jax_load_config(path, TADA50, make_output_dir=False)
    jmodel = jax_build_model(jcfg)
    x = jnp.zeros((1, 4, 32, 32, 3), jnp.float32)
    _, jinter = jax.eval_shape(lambda v: jmodel.apply_with_intermediates(
        v, {"video": x}), jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), {"video": x})))
    want = [n for n, _ in jvis._iter_feature_maps(jinter)]
    cfg = load_config(path, TADA50, make_output_dir=False)
    model = build_model(cfg, device="cpu")
    _, inter = model.forward_with_intermediates(torch.zeros(1, 4, 32, 32, 3))
    got = [n for n, _ in pvis._iter_feature_maps(inter)]
    with open(TADA_NAMES) as f:
        listed = f.read().split()
    assert len(want) == 261
    assert sorted(got) == sorted(want) == sorted(listed)


def test_test_task_dumps_the_first_batch(repo_root, tmp_path):
    """``VISUALIZATION.ENABLE`` in the test task: the first batch's maps
    under ``FEATURE_MAPS.BASE_OUTPUT_DIR``, and the test still runs."""
    cfg = load_config(os.path.join(repo_root, TINY), VIS + [
        "TEST.BATCH_SIZE", "4", "TEST.NUM_SAMPLES_LIMIT", "4",
        "VISUALIZATION.FEATURE_MAPS.BASE_OUTPUT_DIR", str(tmp_path / "maps"),
        "VISUALIZATION.NAME", "tiny", "OUTPUT_DIR", str(tmp_path / "out"),
        "LOG_MODEL_INFO", "false"], make_output_dir=False)
    meter = port_test.test(cfg, device="cpu")
    assert meter.timing["batches"] > 0
    files = sorted(str(p.relative_to(tmp_path / "maps" / "tiny"))
                   for p in (tmp_path / "maps").rglob("*.jpg"))
    assert files == [f"im_{i}/dist_net.temporal_stem_feature.jpg"
                     for i in range(4)]


def test_visualize_features_tool(repo_root, tmp_path, capsys):
    """The tool on synthetic clips: one file a clip, its predictions the
    eval step's."""
    from dist_tpu_torch.tasks.state import make_eval_step

    argv = ["--cfg", os.path.join(repo_root, TINY), "--device", "cpu",
            "TEST.BATCH_SIZE", "2", "OUTPUT_DIR", str(tmp_path)]
    assert visualize_features.main(argv) == 0
    assert "wrote 2 feature maps" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.rglob("*.jpg")) == [
        "dist_net.temporal_stem_feature.jpg"] * 2
    cfg = load_config(os.path.join(repo_root, TINY),
                      ["TEST.BATCH_SIZE", "2", "OUTPUT_DIR", str(tmp_path)],
                      make_output_dir=False)
    written, preds, video = visualize_features.visualize(cfg, device="cpu")
    model, text = visualize_features.load_model(cfg, "cpu")
    want = make_eval_step(model, cfg)({"video": torch.from_numpy(video),
                                       "text_features": text})["preds"]
    assert written == 2 and torch.equal(preds, want)
