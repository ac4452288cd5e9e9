"""The yardstick's arithmetic: the model's operations and each kernel's
least time, by hand against the numbers the bring-up measured against,
and a share above 100 % refused."""

import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, roofline
from benchmark.ops import k1, k1b, k2, k3
from benchmark.reference.model import logits, normalize_video
from benchmark.reference.precision import Precision
from benchmark.tests import tiny
from benchmark import weights

VIT_B16 = {"image_resolution": 224, "vision_patch_size": 16,
           "vision_width": 768, "vision_layers": 12, "embed_dim": 512}


def test_frame_flops_of_vit_b16():
    # 12 x (24 T d^2 + 4 T^2 d), T = 197 tokens, d = 768: 34.9 GFLOP
    assert flops.frame_flops(VIT_B16) == 12 * (24 * 197 * 768 ** 2
                                              + 4 * 197 ** 2 * 768)
    assert round(flops.frame_flops(VIT_B16) / 1e9, 1) == 34.9


@pytest.mark.parametrize("op, shape, ms", [
    (k1, (256, 197, 2304, 12), 0.092494),      # K1, train
    (k1, (64, 197, 2304, 12), 0.023123),       # K1, serving at 8 clips
    (k1b, (256, 197, 2304, 12), 0.16186),      # K1b, train
    (k2, (32, 16, 14, 14, 96, 96, 3), 0.022443),   # K2, train
    (k3, (32, 16, 14, 14, 96, 96, 3), 0.067329),   # K3, train
])
def test_kernel_bounds(op, shape, ms):
    got = roofline.bound_s(*op.work(shape)) * 1e3
    assert got == pytest.approx(ms, rel=5e-5)


def test_kernel_shapes_follow_the_cells():
    dist = tiny.config("dist_b16_ssv2")["reference"]
    full = __import__("json").load(open(
        "benchmark/configs/dist_b16_ssv2.json"))["reference"]
    assert k1.shape_of(full, 32) == (256, 197, 2304, 12)
    assert k2.shape_of(full, 32) == (32, 16, 14, 14, 96, 96, 3)
    assert k1.shape_of(dist, 4) == (8, 17, 192, 1)


def _fake_run(kind, batches, range_s, spec):
    return types.SimpleNamespace(
        kind=kind, spec=spec, root=".", cell={"name": "fake"},
        trace=types.SimpleNamespace(batches=batches, range_s=range_s))


def test_a_share_above_full_is_an_error():
    full = __import__("json").load(open(
        "benchmark/configs/dist_b16_ssv2.json"))["reference"]
    least = 12 * roofline.bound_s(*k1.work(k1.shape_of(full, 32)))
    run = _fake_run("train", [32], {k1.RANGES[0]: 2 * least}, full)
    assert roofline.op_share(run, "k1") == pytest.approx(50.0)
    run = _fake_run("train", [32], {k1.RANGES[0]: 0.5 * least}, full)
    with pytest.raises(roofline.ShareAboveFull):
        roofline.op_share(run, "k1")
    with pytest.raises(roofline.ShareAboveFull):
        roofline.mfu(2 * 989e12, 1.0, 1, "mfu")
    assert roofline.mfu(989e12 / 4, 1.0, 1, "mfu") == pytest.approx(25.0)


def test_no_calls_or_no_time_reads_nothing():
    full = __import__("json").load(open(
        "benchmark/configs/dist_b16_ssv2.json"))["reference"]
    assert roofline.op_share(_fake_run("train", [32], {}, full), "k1") is None
    assert roofline.op_share(_fake_run("serve", [8], {"x": 1.0}, full), "k3") is None


@pytest.mark.parametrize("name", ["dist_b16_ssv2", "clip_ft_b16_ssv2"])
def test_hand_count_matches_the_reference(name):
    """The hand count of one served clip against torch's count of the
    reference's products at the tiny size."""
    spec = tiny.config(name)["reference"]
    w = weights.make_weights(spec, 5, torch.device("cpu"))
    video = weights.make_clips(1, spec["num_frames"], spec["crop"], 6,
                               torch.device("cpu"))
    text = torch.randn(spec["classes"], spec["arch"]["embed_dim"])
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        logits(Precision(), normalize_video(video, spec["mean"], spec["std"]),
               w, spec, text if spec["head"] == "text" else None)
    assert flops.clip_flops(spec, train=False) == fc.get_total_flops()
