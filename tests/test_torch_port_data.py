"""The port's data pieces against the JAX package's: the CLIP tokenizer
(``re`` in place of ``regex``), label-text resolution, the uint8
normalisation, the registry, and the datasets: ``Synthetic`` items bit
for bit, the list files of SSV2, Kinetics-400 and EPIC-KITCHENS-100, the
SSV2 flip with its label remap and the decode-retry neighbour
fallback."""

import json
import os

import numpy as np
import pytest
import torch

from dist_tpu.config import load_config as jax_load_config
from dist_tpu.data import base_dataset as jax_base
from dist_tpu.data import datasets as jax_datasets
from dist_tpu.data import tokenizer as jax_tokenizer
from dist_tpu.data.base_dataset import resolve_label_texts as jax_resolve
from dist_tpu.data.transforms import normalize_device as jax_normalize
from dist_tpu_torch.config import load_config
from dist_tpu_torch.data import base_dataset, datasets, tokenizer
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


TINY = "configs/projects/dist/test/tiny_synth.yaml"


def _cfgs(repo_root, *opts):
    path = os.path.join(repo_root, TINY)
    return (load_config(path, list(opts), make_output_dir=False),
            jax_load_config(path, list(opts), make_output_dir=False))


def _assert_items_equal(got, want):
    """Equal bit for bit, the video of a train item (through a random
    resized crop, resized as OpenCV resizes) too."""
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_synthetic_items_match_jax(repo_root, split):
    cfg, jcfg = _cfgs(repo_root, "TEST.NUM_ENSEMBLE_VIEWS", "3",
                      "TEST.NUM_SPATIAL_CROPS", "3", "TEST.NUM_SAMPLES_LIMIT",
                      "2", "TRAIN.NUM_SAMPLES_LIMIT", "4")
    got = datasets.Synthetic(cfg, split)
    want = jax_datasets.Synthetic(jcfg, split)
    assert len(got) == len(want) == (18 if split == "test" else 4)
    np.testing.assert_array_equal(got.text_tokens, want.text_tokens)
    # a train item without a seed draws fresh entropy on both sides
    train = split == "train"
    for i in range(len(want)):
        assert got._view_indices(i) == want._view_indices(i)
        for seed in (12, 11) if train else (None, 11):
            _assert_items_equal(got.__getitem__(i, seed),
                                want.__getitem__(i, seed))


def _write_lists(tmp_path):
    ssv2 = [{"id": str(100 + i), "label_idx": str(lab)}
            for i, lab in enumerate([86, 3, 93, 166, 5])]
    for split in ("train", "validation"):
        (tmp_path / f"something-something-v2-{split}-with-label.json"
         ).write_text(json.dumps(ssv2))
    for split in ("train", "val", "test"):
        (tmp_path / f"kinetics400_{split}_list.txt").write_text(
            "a/x.mp4 3\nb/y.mp4,7\n\nc/z.mp4 399\n")
    for split in ("train", "test"):
        (tmp_path / f"epickitchen100_{split}_list.txt").write_text(
            "P01/v1.mp4 4 10\nP02/v2.mp4,1,250\n")


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("name", ["Ssv2", "Kinetics400", "Epickitchen100"])
def test_list_datasets_match_jax(repo_root, tmp_path, name, split):
    _write_lists(tmp_path)
    opts = ["DATA.ANNO_DIR", str(tmp_path), "DATA.DATA_ROOT_DIR", "/videos",
            "DATA.DATASET_LABEL_TEXT.ENABLE", "false",
            "TEST.NUM_ENSEMBLE_VIEWS", "2", "TEST.NUM_SPATIAL_CROPS", "3"]
    cfg, jcfg = _cfgs(repo_root, *opts)
    got = base_dataset.DATASET_REGISTRY.get_strict(name)(cfg, split)
    want = jax_base.DATASET_REGISTRY.get_strict(name)(jcfg, split)
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        assert got._get_sample_info(i) == want._get_sample_info(i)
        assert got._view_indices(i) == want._view_indices(i)


def _fake_video(monkeypatch, bad=()):
    """Both packages decode every path to the same frames (a function of
    the path and the indices); paths in ``bad`` fail to open."""
    def probe(path):
        if path in bad:
            raise IOError(f"cannot open {path}")
        return 60, 30.0

    def read(path, indices):
        seed = sum(map(ord, path))
        base = np.random.default_rng(seed).integers(
            0, 256, (60, 40, 52, 3), dtype=np.uint8)
        return base[np.asarray(indices)]

    for mod in (base_dataset, jax_base):
        monkeypatch.setattr(mod, "probe_video", probe)
        monkeypatch.setattr(mod, "read_video", read)


def test_ssv2_flip_remaps_labels_as_jax(repo_root, tmp_path, monkeypatch):
    """SSV2's train flip swaps the directional classes (86/87, 93/94,
    166/167); the port draws the same flips as the JAX package. Its video
    went through a random resized crop, equal to OpenCV's."""
    _write_lists(tmp_path)
    _fake_video(monkeypatch)
    cfg, jcfg = _cfgs(repo_root, "DATA.ANNO_DIR", str(tmp_path),
                      "DATA.DATASET_LABEL_TEXT.ENABLE", "false",
                      "DATA.TRAIN_CROP_SIZE", "32")
    got, want = datasets.Ssv2(cfg, "train"), jax_datasets.Ssv2(jcfg, "train")
    labels = []
    for seed in range(24):
        g, w = got.__getitem__(0, seed), want.__getitem__(0, seed)
        _assert_items_equal(g, w)
        labels.append(int(g["label"]))
    assert set(labels) == {86, 87}
    assert base_dataset.SSV2_FLIP_LABEL_MAP == jax_base.SSV2_FLIP_LABEL_MAP


def test_decode_retry_takes_the_neighbour(repo_root, tmp_path, monkeypatch):
    _write_lists(tmp_path)
    _fake_video(monkeypatch, bad=("/videos/101.mp4", "/videos/102.mp4"))
    opts = ["DATA.ANNO_DIR", str(tmp_path), "DATA.DATA_ROOT_DIR", "/videos",
            "DATA.DATASET_LABEL_TEXT.ENABLE", "false", "DATA.TEST_SCALE", "40",
            "DATA.TEST_CROP_SIZE", "32"]
    cfg, jcfg = _cfgs(repo_root, *opts)
    got, want = datasets.Ssv2(cfg, "test"), jax_datasets.Ssv2(jcfg, "test")
    g, w = got[1], want[1]
    assert int(g["index"]) == 3 and int(g["label"]) == 166
    _assert_items_equal(g, w)
    # nothing decodes: the port raises after its retries
    _fake_video(monkeypatch, bad=tuple(f"/videos/{100 + i}.mp4"
                                       for i in range(5)))
    with pytest.raises(IOError, match="after retries"):
        got[0]


def test_unported_options_name_their_roadmap_item(repo_root):
    for opts, item in (
            (["PRETRAIN.ENABLE", "true"], "SSL/HiCo pretraining"),
            (["AUGMENTATION.AUTOAUGMENT.ENABLE", "true"],
             "data/rand_augment.py"),
            (["AUGMENTATION.RANDOM_ERASING.ENABLE", "true"],
             "data/rand_augment.py")):
        cfg, _ = _cfgs(repo_root, *opts)
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP.md queue A: {item}"):
            datasets.Synthetic(cfg, "train")
