"""Checkpoint intake of the port: torch pickles and TorchScript archives,
the ``module.`` / ``ladder_net.`` clean-up, and the test-checkpoint
priority of ``load_test_checkpoint``."""

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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
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
