"""SSL pretraining's data path in the port against the JAX package's, on
the CPU, exact:

- ``gaussian_blur_clip`` (``dist_tpu_torch/data/transforms.py``) against
  ``cv2.GaussianBlur`` bit for bit, over frame sizes, sigmas and the
  kernels of the 112^2 and 224^2 crops (11 and 23 taps), and against the
  JAX package's function on the same draws;
- ``ContrastiveGenerator`` (``dist_tpu_torch/ssl/generator.py``): the
  views and labels of the JAX package's generator bit for bit on the
  same frames and seed, with ``AUGMENTATION.USE_GPU`` on (crops and
  flips only) and off (colour jitter, blur, grayscale on the host);
- the synthetic dataset under pretraining: its items (distinct clips a
  video) equal the JAX package's bit for bit;
- the multi-clip decode of a listed dataset (``kinetics400``): the same
  frame indices as the JAX package's, in one decoder pass;
- ``Longvideo`` (``dist_tpu_torch/data/long_video.py``) on mp4s written
  with OpenCV: the clip centres and each clip's file and frame indices
  equal the JAX package's exactly under VCL, the gradual schedule at
  three epoch rates, TCL and HiCo++ (with and without ``TCL.MAX_DIS``),
  and an item decoded by the port's native decoder."""

import os

import numpy as np
import pytest

from dist_tpu.data import base_dataset as jbase
from dist_tpu.data import builder as jbuilder
from dist_tpu.data import long_video as jlv
from dist_tpu.data import transforms as jt
from dist_tpu.ssl import generator as jgen
from dist_tpu_torch.data import base_dataset as pbase
from dist_tpu_torch.data import builder as pbuilder
from dist_tpu_torch.data import long_video as plv
from dist_tpu_torch.data import transforms as pt
from dist_tpu_torch.ssl import generator as pgen
from tests.test_torch_port_resnet3d import cfgs

SIMCLR = "configs/projects/hico/simclr_k400_s3dg.yaml"
TINY = "configs/projects/dist/test/tiny_synth.yaml"


def test_gaussian_blur_equals_cv2_bit_for_bit():
    import cv2

    rng = np.random.default_rng(120)
    sizes = [(112, 112), (224, 224), (37, 90), (128, 171), (9, 9)]
    for i in range(40):
        h, w = sizes[i % len(sizes)]
        frames = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
        if i % 3 == 0:   # smooth content as well as noise
            frames = np.clip(np.cumsum(rng.integers(-9, 10, frames.shape),
                                       axis=2) + 128, 0, 255).astype(np.uint8)
        k = max((min(h, w) // 10) | 1, 3)
        sigma = float(rng.uniform(0.1, 2.0))
        got = pt._blur_frames(frames, k, sigma)
        for t in range(2):
            want = cv2.GaussianBlur(frames[t], (k, k), sigma)
            np.testing.assert_array_equal(got[t], want,
                                          err_msg=f"{h}x{w} k {k} {sigma}")
        seed = int(rng.integers(1 << 30))
        np.testing.assert_array_equal(
            pt.gaussian_blur_clip(frames, np.random.default_rng(seed)),
            jt.gaussian_blur_clip(frames, np.random.default_rng(seed)))
    assert pt._gaussian_kernel(11, 1.0).sum() == 256


@pytest.mark.parametrize("use_gpu", [False, True], ids=["host", "device"])
def test_contrastive_generator_views_equal_jax(repo_root, use_gpu):
    opts = ["AUGMENTATION.USE_GPU", str(use_gpu).lower(),
            "PRETRAIN.NUM_CLIPS_PER_VIDEO", "4", "AUGMENTATION.BLUR", "0.7"]
    cfg, jcfg = cfgs(repo_root, SIMCLR, opts)
    rng = np.random.default_rng(121)
    clips = [rng.integers(0, 256, (4, 128, 150, 3), dtype=np.uint8)
             for _ in range(2)]
    for seed in range(4):
        got, glabels = pgen.ContrastiveGenerator(cfg, "train")(
            clips, {}, np.random.default_rng(seed))
        want, wlabels = jgen.ContrastiveGenerator(jcfg, "train")(
            clips, {}, np.random.default_rng(seed))
        assert got.shape == (4, 4, 112, 112, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            glabels["self-supervised"]["contrastive"],
            wlabels["self-supervised"]["contrastive"])
    if use_gpu:
        # crops and flips only: no value the source frames lack
        assert set(np.unique(got)) <= set(np.unique(np.stack(clips)))


def test_synthetic_pretraining_items_equal_jax(repo_root, tmp_path):
    opts = ["OUTPUT_DIR", str(tmp_path), "DATA.NUM_INPUT_FRAMES", "4",
            "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_SCALE", "40",
            "DATA.TEST_CROP_SIZE", "32", "TRAIN.NUM_SAMPLES_LIMIT", "3"]
    cfg, jcfg = cfgs(repo_root, TINY, opts)
    for c in (cfg, jcfg):
        c.PRETRAIN.ENABLE = True
        c.PRETRAIN.GENERATOR = "ContrastiveGenerator"
        c.PRETRAIN.NUM_CLIPS_PER_VIDEO = 3
        c.AUGMENTATION.USE_GPU = True
        c.AUGMENTATION.RATIO = [1, 1]
        c.DATA.TRAIN_JITTER_SCALES = [168, 224]
    pds = pbuilder.build_dataset(cfg, "train")
    jds = jbuilder.build_dataset(jcfg, "train")
    clips, _ = pds._decode_video(pds._get_sample_info(1), 1,
                                 np.random.default_rng(0))
    assert isinstance(clips, list) and len(clips) == 3
    assert not np.array_equal(clips[0], clips[1])
    for index in range(3):
        got, want = pds.__getitem__(index, seed=5), jds.__getitem__(index,
                                                                   seed=5)
        assert set(got) == set(want) == {"video", "label", "contrastive",
                                         "index"}
        assert got["video"].shape == (3, 4, 32, 32, 3)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _record(module, name, monkeypatch, frames_shape=(8, 8, 3)):
    calls = []

    def read(path, idx):
        calls.append((path, np.asarray(idx).tolist()))
        return np.zeros((len(idx),) + frames_shape, np.uint8)

    monkeypatch.setattr(module, name, read)
    return calls


def test_multi_clip_decode_reads_once_with_jax_indices(repo_root, tmp_path,
                                                        monkeypatch):
    (tmp_path / "kinetics400_train_list.txt").write_text(
        "a.mp4 3\nb.mp4 1\n")
    opts = ["DATA.ANNO_DIR", str(tmp_path), "DATA.DATA_ROOT_DIR",
            str(tmp_path), "TRAIN.DATASET", "kinetics400",
            "DATA.NUM_INPUT_FRAMES", "4", "PRETRAIN.NUM_CLIPS_PER_VIDEO", "3"]
    cfg, jcfg = cfgs(repo_root, SIMCLR, opts)
    for mod in (pbase, jbase):
        monkeypatch.setattr(mod, "probe_video", lambda path: (300, 30.0))
    got = _record(pbase, "read_video", monkeypatch)
    want = _record(jbase, "read_video", monkeypatch)
    pds = pbuilder.build_dataset(cfg, "train")
    jds = jbuilder.build_dataset(jcfg, "train")
    for index in range(2):
        p, _ = pds._decode_video(pds._get_sample_info(index), index,
                                 np.random.default_rng(index))
        j, _ = jds._decode_video(jds._get_sample_info(index), index,
                                 np.random.default_rng(index))
        assert len(p) == len(j) == 3
        assert [c.shape[0] for c in p] == [4, 4, 4]
    assert len(got) == 2 and got == want     # one pass a video
    assert len(set(map(tuple, np.split(np.asarray(got[0][1]), 3)))) == 3


def _write_video(path, n_frames=60, fps=30, size=48):
    import cv2

    os.makedirs(os.path.dirname(path), exist_ok=True)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                        (size, size))
    assert w.isOpened()
    for i in range(n_frames):
        w.write(np.full((size, size, 3), (7 * i) % 255, np.uint8))
    w.release()


@pytest.fixture(scope="module")
def long_video_root(tmp_path_factory):
    """Two untrimmed videos: vid1 of three 2 s sub-clips, vid2 of one."""
    root = str(tmp_path_factory.mktemp("lv"))
    spans = {"vid1": ((0, 2000), (2000, 4000), (4000, 6000)),
             "vid2": ((0, 2000),)}
    lines = []
    for name, clips in spans.items():
        for s, e in clips:
            _write_video(os.path.join(root, "training",
                                      f"v_{name}_{s}_{e}.mp4"))
            lines.append(f"{name},{s},{e}")
    with open(os.path.join(root, "training.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return root


PLACEMENTS = {
    "vcl": (["HICO.VCL.ENABLE", "true", "HICO.GRAUDAL_SAMPLING.ENABLE",
             "false"], 2, False),
    "gradual-tcl": (["HICO.GRAUDAL_SAMPLING.ENABLE", "true",
                     "HICO.TCL.ENABLE", "true"], 3, False),
    "free": (["HICO.GRAUDAL_SAMPLING.ENABLE", "false"], 3, False),
    "hico++": (["HICO.GRAUDAL_SAMPLING.ENABLE", "true",
                "HICO.TCL.ENABLE", "true"], 6, True),
    "hico++-tcl_max_dis": (["HICO.GRAUDAL_SAMPLING.ENABLE", "true",
                            "HICO.TCL.ENABLE", "true"], 6, True),
}


@pytest.mark.parametrize("case", list(PLACEMENTS))
def test_longvideo_placement_equals_jax(repo_root, long_video_root, case,
                                        monkeypatch):
    opts, n, plus = PLACEMENTS[case]
    base = ["DATA.DATA_ROOT_DIR", long_video_root, "DATA.ANNO_DIR",
            long_video_root, "DATA.NUM_INPUT_FRAMES", "4",
            "DATA.SAMPLING_RATE", "4", "DATA.TRAIN_CROP_SIZE", "32",
            "PRETRAIN.NUM_CLIPS_PER_VIDEO", str(n),
            "DATA.HICO_PLUS_PLUS.ENABLE", str(plus).lower()]
    cfg, jcfg = cfgs(repo_root, SIMCLR, base + opts)
    if case == "hico++-tcl_max_dis":
        for c in (cfg, jcfg):
            c.HICO.TCL.MAX_DIS = 0.5
    pds, jds = plv.Longvideo(cfg, "train"), jlv.Longvideo(jcfg, "train")
    assert len(pds) == len(jds) == 2
    got = _record(plv, "read_video", monkeypatch)
    want = _record(jlv, "read_video_cv2", monkeypatch)
    gradual = "gradual" in case or "hico++" in case
    rates = (0.0, 0.5, 1.0) if gradual else (0.0,)
    for rate in rates:
        pds.set_epoch_rate(rate)
        jds.set_epoch_rate(rate)
        for index in range(2):
            for seed in range(3):
                info = pds._get_sample_info(index)
                assert info == jds._get_sample_info(index)
                pc, pt_ = pds._clip_centers(info["duration"],
                                            np.random.default_rng(seed))
                jc, jt_ = jds._clip_centers(info["duration"],
                                            np.random.default_rng(seed))
                assert pc == jc and pt_ == jt_ and len(pc) == n
                pds._decode_video(info, index, np.random.default_rng(seed))
                jds._decode_video(info, index, np.random.default_rng(seed))
    assert got == want and len(got) == n * 2 * 3 * len(rates)
    # several sub-clip files are read from
    assert len({path for path, _ in got}) > 1


def test_longvideo_item_decodes_with_the_native_decoder(repo_root,
                                                         long_video_root):
    from dist_tpu_torch.data import native_decoder

    if not native_decoder.available():
        pytest.skip(f"no native decoder here: {native_decoder.status()}")
    opts = ["DATA.DATA_ROOT_DIR", long_video_root, "DATA.ANNO_DIR",
            long_video_root, "DATA.NUM_INPUT_FRAMES", "4",
            "DATA.SAMPLING_RATE", "4", "DATA.TRAIN_CROP_SIZE", "32",
            "PRETRAIN.NUM_CLIPS_PER_VIDEO", "3", "HICO.TCL.ENABLE", "true"]
    cfg, _ = cfgs(repo_root, SIMCLR, opts)
    ds = pbuilder.build_dataset(cfg, "train")
    assert isinstance(ds, plv.Longvideo)
    item = ds.__getitem__(0, seed=3)
    assert item["video"].shape == (3, 4, 32, 32, 3)
    assert item["video"].dtype == np.uint8
    assert list(item["contrastive"]) == [0, 1, 2]
    assert item["video"].std() > 0
