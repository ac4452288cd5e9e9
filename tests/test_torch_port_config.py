"""The port's config layer against the JAX package's: its YAML reader
against PyYAML on every file under configs/, and ``load_config`` against
``dist_tpu.config.load_config`` on every config under
configs/projects/dist/, with and without dotted overrides."""

import glob
import math
import os

import pytest
import yaml

from dist_tpu.config import load_config as jax_load_config
from dist_tpu_torch.config import load_config
from dist_tpu_torch.config import yaml_lite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL_YAML = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))
DIST_YAML = [p for p in ALL_YAML if p.startswith("configs/projects/dist/")]
OPTS = ["TRAIN.BATCH_SIZE", "4", "OPTIMIZER.BASE_LR", "1e-4",
        "OPTIMIZER.WEIGHT_DECAY", "0", "DATA.TRAIN_JITTER_SCALES", "[0.5, 1.0]",
        "TPU.FUSED_TEMPORAL_NET", "true", "VIDEO.HEAD.NAME", "SomeHead",
        "TEST.CHECKPOINT_FILE_PATH", "''", "TPU.MESH.DATA", "0x10"]


@pytest.mark.parametrize("path", ALL_YAML)
def test_yaml_reader_matches_pyyaml(path):
    with open(os.path.join(REPO, path)) as f:
        text = f.read()
    assert yaml_lite.safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "8e-6", "3.2e-5", "1e-4", "0.", ".5", "-.inf", "1_000", "010", "0x1F",
    "0b101", "1:30", "+1", "yes", "Off", "~", "null", "", "'it''s'",
    '"a\\tb"', "[a, 'b c', 1, [2, 3], {k: v}]", "{a: 1, b: [x]}", "a: b",
    "a #c", "a#b", "[1,\n 2]", "-1", "1.0e+3", "1.0e3", "0o17"])
def test_yaml_scalars_match_pyyaml(text):
    want = yaml.safe_load(text)
    got = yaml_lite.safe_load(text)
    if isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("text", ["&anchor x", "*alias", "!!str x",
                                  "key: |\n  block", "2020-01-02",
                                  "key:\n  - item"])
def test_yaml_unsupported_constructs_raise(text):
    with pytest.raises(ValueError):
        yaml_lite.safe_load(text)


@pytest.mark.parametrize("with_opts", [False, True])
@pytest.mark.parametrize("path", DIST_YAML)
def test_load_config_matches_jax(path, with_opts):
    opts = OPTS if with_opts else []
    full = os.path.join(REPO, path)
    want = jax_load_config(full, opts, make_output_dir=False)
    got = load_config(full, opts, make_output_dir=False)
    assert got.to_dict() == want.to_dict()
    # the "1e-" string->float coercion at attribute access
    assert got.OPTIMIZER.BASE_LR == want.OPTIMIZER.BASE_LR
    assert got.OPTIMIZER.WARMUP_START_LR == want.OPTIMIZER.WARMUP_START_LR


def test_bad_overrides_raise():
    path = os.path.join(REPO, DIST_YAML[0])
    with pytest.raises(KeyError):
        load_config(path, ["TRAIN.NO_SUCH_KEY", "1"], make_output_dir=False)
    with pytest.raises(ValueError):
        load_config(path, ["TRAIN.BATCH_SIZE"], make_output_dir=False)
