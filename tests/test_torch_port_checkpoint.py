"""Checkpoint intake of the port: torch pickles and TorchScript archives,
the ``module.`` / ``ladder_net.`` clean-up, the test-checkpoint priority
of ``load_test_checkpoint``, and a JAX-trained tree reaching the port's
test task through ``state_dict_from_jax`` (the JAX package's Orbax
directory itself is refused, with a message that says how)."""

import os

import pytest
import torch

from dist_tpu_torch.config import load_config
from dist_tpu_torch.models.base.models import build_model
from dist_tpu_torch.models.clip.convert import load_torch_state_dict
from dist_tpu_torch.utils.checkpoint import load_test_checkpoint

TINY = "configs/projects/dist/test/tiny_synth.yaml"


def _cfg(repo_root, *opts):
    return load_config(os.path.join(repo_root, TINY), list(opts),
                       make_output_dir=False)


def test_pickle_is_cleaned_up(tmp_path):
    path = str(tmp_path / "ckpt.pyth")
    torch.save({"epoch": 3, "model_state": {
        "module.visual.proj": torch.ones(2, 2, dtype=torch.float16),
        "module.ladder_net.proj": torch.zeros(3),
        "input_resolution": torch.tensor(224),
        "note": "not a tensor"}}, path)
    sd = load_torch_state_dict(path)
    assert sorted(sd) == ["dist_net.proj", "visual.proj"]
    assert sd["visual.proj"].dtype == torch.float32


def test_torchscript_archive(tmp_path):
    path = str(tmp_path / "clip.pt")
    torch.jit.save(torch.jit.script(torch.nn.Linear(2, 3)), path)
    sd = load_torch_state_dict(path)
    assert sorted(sd) == ["bias", "weight"]
    assert tuple(sd["weight"].shape) == (3, 2)


def test_test_checkpoint_loads_and_renames(repo_root, tmp_path):
    cfg = _cfg(repo_root)
    src = build_model(cfg, device="cpu", seed=7).module.state_dict()
    src["logit_scale"] = torch.tensor(1.25)
    renamed = {"module." + k.replace("dist_net.", "ladder_net."): v
               for k, v in src.items()}
    path = str(tmp_path / "best.pyth")
    torch.save({"model_state": renamed}, path)

    cfg = _cfg(repo_root, "TEST.CHECKPOINT_FILE_PATH", path,
               "OUTPUT_DIR", str(tmp_path / "out"))
    model = load_test_checkpoint(cfg, build_model(cfg, device="cpu", seed=0))
    got = model.module.state_dict()
    assert float(got["logit_scale"]) == 1.25
    for k, v in src.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)


def test_orbax_checkpoint_is_refused(repo_root, tmp_path):
    ckpt = tmp_path / "out" / "checkpoints" / "checkpoint_epoch_00001"
    ckpt.mkdir(parents=True)
    cfg = _cfg(repo_root, "OUTPUT_DIR", str(tmp_path / "out"))
    # the error says how to bring the tree across
    with pytest.raises(NotImplementedError, match="state_dict_from_jax"):
        load_test_checkpoint(cfg, build_model(cfg, device="cpu"))


def test_unreadable_checkpoint_falls_through(repo_root, tmp_path):
    bad = tmp_path / "broken.pyth"
    bad.write_bytes(b"not a checkpoint")
    cfg = _cfg(repo_root, "TEST.CHECKPOINT_FILE_PATH", str(bad),
               "OUTPUT_DIR", str(tmp_path / "out"))
    model = build_model(cfg, device="cpu")
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    load_test_checkpoint(cfg, model)
    for k, v in model.module.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


def test_jax_tree_reaches_the_port_test_task(repo_root, tmp_path):
    """A JAX TrainState saved as the JAX package's Orbax checkpoint gives
    the JAX test task's per-video scores; its params through
    ``state_dict_from_jax`` into a ``.pyth`` give the port's test task the
    same scores (fp32, within 1e-4: float32 sums in another order). The
    port refuses the Orbax directory itself."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import dist_tpu.tasks.test as jax_test
    from dist_tpu.config import load_config as jax_load_config
    from dist_tpu.models.base.models import build_model as jax_build_model
    from dist_tpu.tasks.state import TrainState, init_variables
    from dist_tpu.utils.checkpoint import save_checkpoint
    from dist_tpu_torch.models.clip.convert import state_dict_from_jax, to_torch
    from dist_tpu_torch.tasks.test import test

    out = str(tmp_path / "out")
    opts = ["TRAIN.MIXED_PRECISION", "false", "OUTPUT_DIR", out,
            "RANDOM_SEED", "5"]
    jcfg = jax_load_config(os.path.join(repo_root, TINY), opts)
    # "trained": moved off the init that the JAX task would otherwise make
    # from the same seed, so its scores show the checkpoint was read
    variables = jax.tree_util.tree_map(
        lambda x: x * 1.05,
        init_variables(jcfg, jax_build_model(jcfg), (4, 64, 64, 3)))
    save_checkpoint(jcfg, TrainState(
        step=jnp.zeros((), jnp.int32), variables=variables, opt_state=(),
        ema_variables=None), 0)
    meters = []

    class Recorded(jax_test.TestMeter):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            meters.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_test, "TestMeter", Recorded)
        want = jax_test.test(jcfg)
    ckpt = str(tmp_path / "from_jax.pyth")
    torch.save(to_torch(state_dict_from_jax(
        jax.device_get(variables["params"]))), ckpt)
    got = test(_cfg(repo_root, *opts, "TEST.CHECKPOINT_FILE_PATH", ckpt),
               device="cpu")
    np.testing.assert_allclose(got.video_preds, meters[0].video_preds,
                               atol=1e-4, rtol=0)
    assert got.stats == want
    with pytest.raises(NotImplementedError, match="state_dict_from_jax"):
        test(_cfg(repo_root, *opts), device="cpu")
