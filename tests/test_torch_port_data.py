"""The port's data pieces against the JAX package's: the CLIP tokenizer
(``re`` in place of ``regex``), label-text resolution, the uint8
normalisation, and the registry."""

import json
import os

import numpy as np
import pytest
import torch

from dist_tpu.config import load_config as jax_load_config
from dist_tpu.data import tokenizer as jax_tokenizer
from dist_tpu.data.base_dataset import resolve_label_texts as jax_resolve
from dist_tpu.data.transforms import normalize_device as jax_normalize
from dist_tpu_torch.config import load_config
from dist_tpu_torch.data import tokenizer
from dist_tpu_torch.data.base_dataset import resolve_label_texts
from dist_tpu_torch.data.transforms import normalize_device
from dist_tpu_torch.utils.registry import Registry

TEXTS = [
    "a video of class 7", "Pushing something from left to right",
    "Putting [something] onto [something else]", "it's 3:30 -- they'll go!",
    "Tearing something into two pieces", "  multiple   spaces\tand\nlines ",
    "&amp; html &lt;escapes&gt;", "snake_case_words and CamelCase",
    "café naïve Zürich", "数字 123 and ümlauts", "emoji 🙂 symbols #$%",
    "x" * 300,
]


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_matches_jax(text):
    np.testing.assert_array_equal(tokenizer.tokenize(text),
                                  jax_tokenizer.tokenize(text))


def test_label_texts_match_jax(repo_root, tmp_path):
    path = os.path.join(repo_root, "configs/projects/dist/test/tiny_synth.yaml")
    labels = {'"Holding something"': 1, "Pushing something": 0,
              "Moving something up": 2}
    (tmp_path / "labels.json").write_text(json.dumps(labels))
    for anno in ("", str(tmp_path)):
        opts = ["DATA.ANNO_DIR", anno, "DATA.DATASET_LABEL_TEXT.PROMPT",
                "a video of"]
        names, tokens = resolve_label_texts(
            load_config(path, opts, make_output_dir=False), 12)
        jnames, jtokens = jax_resolve(
            jax_load_config(path, opts, make_output_dir=False), 12)
        assert names == jnames
        np.testing.assert_array_equal(tokens, jtokens)


def test_normalize_device_matches_jax():
    rng = np.random.default_rng(0)
    video = rng.integers(0, 256, (2, 3, 4, 5, 3), dtype=np.uint8)
    mean, std = [0.48145466, 0.4578275, 0.40821073], [0.26862954, 0.26130258,
                                                      0.27577711]
    got = normalize_device(torch.from_numpy(video), mean, std).numpy()
    want = np.asarray(jax_normalize(video, mean, std))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_registry():
    reg = Registry("Thing")

    @reg.register()
    class A:
        pass

    reg.register(len, name="length")
    assert reg.get("A") is A and reg.get_strict("length") is len
    assert reg.get("missing") is None and "A" in reg
    with pytest.raises(KeyError):
        reg.register(A)
    with pytest.raises(KeyError):
        reg.get_strict("missing")
