"""The benchmark's cells cut to a size the CPU runs in seconds: the same
configuration files and traffic, with the repository's tiny CLIP
(ViT-Test: width 64, 2 blocks) and a side network of 2 steps, 4 frames of
64^2, batch 4, 12 classes, in fp32."""

import copy
import json
import os

import torch

from benchmark import harness, spec

ARCH = {"embed_dim": 32, "image_resolution": 64, "vision_layers": 2,
        "vision_width": 64, "vision_heads": 1, "vision_patch_size": 16,
        "context_length": 77, "vocab_size": 49408, "transformer_width": 64,
        "transformer_heads": 1, "transformer_layers": 2}
OPTS = ["VIDEO.BACKBONE.META_ARCH_NAME", "ViT-Test", "DATA.NUM_INPUT_FRAMES", "4",
        "DATA.TRAIN_CROP_SIZE", "64", "DATA.TEST_CROP_SIZE", "64",
        "TRAIN.BATCH_SIZE", "4", "TEST.BATCH_SIZE", "4",
        "VIDEO.HEAD.NUM_CLASSES", "12", "TRAIN.MIXED_PRECISION", "false",
        "VIDEO.BACKBONE.DIST.SELECTED_LAYERS", "[0, 1]",
        "VIDEO.BACKBONE.DIST.INTEGRATION_DIM", "64",
        "VIDEO.BACKBONE.DIST.TEMPORAL_DIM", "32"]
# the numbers fp32 on the CPU holds the program to (the cells' limits are
# for bf16 at full size)
LIMITS = {"train": {"loss_gap": {"limit": 1e-4}, "grad_gap": {"limit": 1e-3},
                    "change_gap": {"limit": 1e-3}},
          "serve": {"score_gap": {"limit": 1e-4}}}


def config(name):
    c = copy.deepcopy(json.load(open(os.path.join(spec.ROOT, "benchmark", "configs",
                                                  f"{name}.json"))))
    c["opts"] = list(c["opts"]) + OPTS
    c["batch"], c["serve_batch"] = 4, 4
    r = c["reference"]
    r["arch"], r["crop"], r["classes"] = dict(ARCH), 64, 12
    r["num_frames"] = 4
    if r.get("dist"):
        r["dist"].update(selected_layers=[0, 1], integration_dim=64,
                         temporal_dim=32, num_frames=4)
    if "dropout_dtype" in r["train"]:
        r["train"]["dropout_dtype"] = "float32"
    r["train"]["block"] = 2
    drop = {"TRAIN.BATCH_SIZE", "TEST.BATCH_SIZE", "DATA.NUM_INPUT_FRAMES",
            "DATA.TRAIN_CROP_SIZE", "DATA.TEST_CROP_SIZE", "VIDEO.HEAD.NUM_CLASSES",
            "VIDEO.BACKBONE.META_ARCH_NAME", "TRAIN.MIXED_PRECISION"}
    c["expect"] = {k: v for k, v in c["expect"].items()
                   if k not in drop and not k.startswith("VIDEO.BACKBONE.DIST.")}
    return c


def run(cell_name, seed=1234, seconds=0.5, traced=False, kind=None):
    """A :class:`harness.Run` of the tiny cell on the CPU."""
    bench = spec.benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    traffic = json.load(open(os.path.join(spec.ROOT, "benchmark", "traffic",
                                          f"{cell['traffic']}.json")))
    if traffic["kind"] == "serve":
        traffic = dict(traffic, rate=20.0, pool_clips=6, check_sample=6,
                       ref_block=3)
    else:
        traffic = dict(traffic, pool_batches=4)
    return harness.Run(cell=cell, config=config(cell["config"]),
                       traffic=traffic, limits=LIMITS[traffic["kind"]],
                       seed=seed, seconds=seconds, traced=traced,
                       device=torch.device("cpu"), t_start=harness.now())
