"""The CLIP fine-tune (``configs/projects/dist/vit_base_16_ssv2.yaml`` with
``VIDEO.HEAD.NAME ClipVideoHeadLinear``: the whole vision tower trained
under a linear head over the video embedding) against the JAX package's,
on the CPU, at the ViT-Test geometry (width 64, 2 layers of one head of
64, 4 frames of 64^2, 174 classes) in fp32, with the same numpy weights
carried across by ``state_dict_from_jax``.

Mixup, cutmix and the head's dropout (0.5 as shipped) are off in the
comparisons: each package draws them from its own random stream
(``ROADMAP.md`` C). The LR is 0.01 with no warm-up, so that AdamW's
decoupled decay moves the text tower's leaves, which get a zero gradient
on this path, by more than a rounding step.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.synth_ckpt import make_clip_state_dict
from dist_tpu.config import load_config as jax_load_config
from dist_tpu.models.base.models import build_model as jax_build_model
from dist_tpu.models.clip.convert import convert_clip_params
from dist_tpu.optim import optimizer as jopt
from dist_tpu.tasks import state as jstate
from dist_tpu_torch import run
from dist_tpu_torch.config import load_config
from dist_tpu_torch.models.base.models import ClipVideoHeadLinear, build_model
from dist_tpu_torch.models.clip.convert import state_dict_from_jax, to_torch
from dist_tpu_torch.models.clip.model import Transformer
from dist_tpu_torch.optim import optimizer as popt
from dist_tpu_torch.tasks.state import (
    create_train_state,
    make_eval_step,
    make_train_step,
)
from dist_tpu_torch.utils import checkpoint as cu

CFG = "configs/projects/dist/vit_base_16_ssv2.yaml"
TINY = ["VIDEO.HEAD.NAME", "ClipVideoHeadLinear",
        "VIDEO.BACKBONE.META_ARCH_NAME", "ViT-Test",
        "DATA.NUM_INPUT_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "64",
        "DATA.TEST_SCALE", "64", "DATA.TEST_CROP_SIZE", "64"]
PARITY = ["TRAIN.MIXED_PRECISION", "false", "AUGMENTATION.MIXUP.ENABLE",
          "false", "AUGMENTATION.CUTMIX.ENABLE", "false",
          "VIDEO.HEAD.DROPOUT_RATE", "0", "OPTIMIZER.WARMUP_EPOCHS", "0",
          "OPTIMIZER.BASE_LR", "0.01"]
# the label-text variant: the vision tower trained under the cosine
# classifier against label-text features passed in
TEXT = ["VIDEO.HEAD.NAME", "ClipVideoTextIdentity"]
ARCH = dict(embed_dim=32, image_resolution=64, vision_layers=2,
            vision_width=64, vision_patch_size=16, context_length=77,
            vocab_size=49408, transformer_width=64, transformer_layers=2)
STEPS, B, SPE = 3, 2, 4
CLASSES = 174


def _cfgs(repo_root, *opts):
    path = os.path.join(repo_root, CFG)
    opts = TINY + PARITY + list(opts)
    return (load_config(path, opts, make_output_dir=False),
            jax_load_config(path, opts, make_output_dir=False))


def _variables(seed=0):
    """Numpy weights in the JAX layout: the synthetic CLIP, a head."""
    rng = np.random.default_rng(seed)
    params, _ = convert_clip_params(make_clip_state_dict(rng, **ARCH))
    head = {"out": {
        "kernel": (rng.standard_normal((ARCH["embed_dim"], CLASSES))
                   * 0.2).astype(np.float32),
        "bias": (rng.standard_normal(CLASSES) * 0.1).astype(np.float32)}}
    return {"params": params, "head": head}


def _batches(text):
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((CLASSES, ARCH["embed_dim"])).astype(
        np.float32)
    out = []
    for _ in range(STEPS):
        b = {"video": rng.integers(0, 256, (B, 4, 64, 64, 3), dtype=np.uint8),
             "labels": rng.integers(0, CLASSES, B).astype(np.int32)}
        if text:
            b["text_features"] = feats
        out.append(b)
    return out


def _jax_run(jcfg, variables, batches):
    """The JAX package's jitted train step: each step's metrics and the
    final variables as the port's state dict."""
    model = jax_build_model(jcfg)
    tx, lr_fn = jopt.construct_optimizer(jcfg, variables, SPE)
    state = jstate.create_train_state(variables, tx, None)
    step = jax.jit(jstate.make_train_step(model, jcfg, tx, lr_fn))
    metrics = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    final = jax.device_get(state.variables)
    return metrics, state_dict_from_jax(
        final if "head" in final else final["params"])


def _port_model(cfg, variables):
    model = build_model(cfg, device="cpu")
    sd = state_dict_from_jax(variables if "head" in variables
                             else variables["params"])
    model.module.load_state_dict(to_torch(sd))
    return model


def _port_run(cfg, variables, batches):
    model = _port_model(cfg, variables)
    optimizer, lr_fn = popt.construct_optimizer(cfg, model.module, SPE)
    state = create_train_state(model, optimizer, None)
    step = make_train_step(model, cfg, optimizer, lr_fn)
    metrics, grads = [], []
    for b in batches:
        tb = {"video": torch.from_numpy(b["video"]),
              "labels": torch.from_numpy(b["labels"]).long()}
        if "text_features" in b:
            tb["text_features"] = torch.from_numpy(b["text_features"])
        metrics.append({k: float(v) for k, v in step(state, tb).items()})
        grads.append({k: p.grad.clone() for k, p in
                      model.module.named_parameters() if p.requires_grad})
    return metrics, grads, model, [lr_fn(k) for k in range(STEPS)]


@pytest.fixture(scope="module")
def runs(repo_root):
    """The JAX and port runs of both variants (linear head, and the
    label-text head), the port's linear run with and without remat."""
    out = {}
    for name, extra in (("linear", []), ("text", TEXT)):
        cfg, jcfg = _cfgs(repo_root, *extra)
        variables = _variables()
        if name == "text":
            variables = {"params": variables["params"]}
        batches = _batches(text=name == "text")
        out[name] = {"jax": _jax_run(jcfg, variables, batches),
                     "port": _port_run(cfg, variables, batches),
                     "cfg": cfg}
    cfg, _ = _cfgs(repo_root, "TPU.REMAT", "true")
    out["remat"] = _port_run(cfg, _variables(), _batches(text=False))
    return out


def _hold_leaves(cfg, port, want_sd):
    """Every leaf after three AdamW steps against the JAX package's.
    Adam sends each element to about +-lr, whatever its gradient's size,
    so where every step's gradient is at least 1e-3 of its tensor's
    largest the leaf is held to 1e-6 + 1% of sum_k lr_k; elsewhere to the
    most AdamW can move an element, 2 (1 - beta1) / sqrt(1 - beta2)
    sum_k lr_k. A leaf with no gradient on the path moves by the
    decoupled decay alone: held to 1e-6 relative, and it must move."""
    metrics, grads, model, lrs = port
    travel = sum(lrs)
    b1, b2 = cfg.OPTIMIZER.BETAS
    zero_grad = []
    for name, p in model.module.named_parameters():
        got, want = p.detach().numpy(), want_sd[name]
        if all(not g[name].abs().max() > 0 for g in grads):
            zero_grad.append(name)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9,
                                       err_msg=name)
            continue
        steady = np.all([np.abs(g[name].numpy())
                         >= 1e-3 * float(g[name].abs().max()) for g in grads],
                        axis=0)
        err = np.abs(got - want)
        assert (err[steady] <= 1e-6 + 0.01 * travel).all(), (
            name, float(err[steady].max()))
        assert (err <= 2 * (1 - b1) / np.sqrt(1 - b2) * travel).all(), name
    return zero_grad


def _decayed(port, start, names):
    model = port[2]
    return all(not torch.equal(dict(model.module.named_parameters())[k],
                               torch.from_numpy(start[k])) for k in names)


def test_linear_head_forward_matches_jax(repo_root):
    """The eval step's softmax scores against the JAX model's eval
    forward (atol 1e-6: fp32, sums in another order); the train-mode
    forward is held through the steps' losses below."""
    cfg, jcfg = _cfgs(repo_root)
    variables = _variables()
    video = _batches(text=False)[0]["video"]
    jmodel = jax_build_model(jcfg)
    want, _ = jax.jit(lambda v, x: jmodel.apply(v, {"video": x}, train=False))(
        variables, jstate._prep_video(jcfg, jnp.asarray(video)))
    model = _port_model(cfg, variables)
    assert isinstance(model.module.head, ClipVideoHeadLinear)
    assert model.head is None
    got = make_eval_step(model, cfg)({"video": torch.from_numpy(video)})
    assert got["preds"].shape == (B, CLASSES)
    np.testing.assert_allclose(got["preds"].numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("lr_reduce", ["false", "true"])
def test_param_groups_match_jax_name_for_name(repo_root, lr_reduce):
    """``param_labels`` of every port parameter equal the JAX labels of its
    leaf (each JAX label spread over its leaf and carried across by
    ``state_dict_from_jax``, which unstacks the scanned layers)."""
    cfg, jcfg = _cfgs(repo_root, "TRAIN.LR_REDUCE", lr_reduce)
    variables = _variables()
    names = sorted({popt.TRAINABLE, popt.NO_WD, popt.FROZEN, popt.BODY,
                    popt.BN})
    jlabels = jopt.param_labels(jcfg, variables)
    coded = jax.tree_util.tree_map(
        lambda lab, leaf: np.full(np.shape(leaf), names.index(lab),
                                  np.float32), jlabels, variables)
    want = {k: names[int(v.flat[0])] if v.size else None
            for k, v in state_dict_from_jax(coded).items()}
    assert all(np.unique(v).size <= 1
               for v in state_dict_from_jax(coded).values())
    module = build_model(cfg, device="cpu").module
    got = popt.param_labels(cfg, module)
    assert set(got) == set(want)
    for k, lab in got.items():
        assert lab == want[k], (k, lab, want[k])
    assert got["visual.transformer.resblocks.0.attn.in_proj_weight"] == (
        popt.BODY if lr_reduce == "true" else popt.TRAINABLE)
    assert got["head.out.weight"] == got["head.out.bias"] == popt.TRAINABLE
    assert got["token_embedding.weight"] == popt.NO_WD
    assert got["visual.positional_embedding"] == popt.NO_WD
    assert got["transformer.resblocks.0.ln_1.weight"] == (
        popt.BODY if lr_reduce == "true" else popt.TRAINABLE)
    assert got["logit_scale"] == (
        popt.BODY if lr_reduce == "true" else popt.TRAINABLE)


def test_three_linear_head_steps_match_jax(runs):
    """Loss, top-1 error and LR a step (loss rel 1e-5: fp32), every leaf
    (``_hold_leaves``); the vision tower and the head train, the text
    tower and ``logit_scale`` get a zero gradient and are decayed as
    optax's ``add_decayed_weights`` decays them."""
    run_ = runs["linear"]
    jm, jsd = run_["jax"]
    pm = run_["port"][0]
    for k in range(STEPS):
        assert pm[k]["loss"] == pytest.approx(jm[k]["loss"], rel=1e-5)
        assert pm[k]["top1_err"] == jm[k]["top1_err"]
        assert pm[k]["lr"] == pytest.approx(jm[k]["lr"], rel=1e-6)
    zero = _hold_leaves(run_["cfg"], run_["port"], jsd)
    model = run_["port"][2]
    names = [k for k, _ in model.module.named_parameters()]
    assert set(zero) == {k for k in names if model.module.is_text_param(k)
                         or k == "logit_scale"}
    start = state_dict_from_jax(_variables())
    decayed = [k for k in zero
               if popt.param_labels(run_["cfg"], model.module)[k]
               != popt.NO_WD]
    assert decayed and _decayed(run_["port"], start, decayed)
    assert all(p.requires_grad for p in model.module.parameters())


def test_remat_equals_no_remat_bit_for_bit(runs):
    """``TPU.REMAT`` recomputes each vision block in the backward: the
    same losses and weights bit for bit."""
    plain, remat = runs["linear"]["port"], runs["remat"]
    assert [m["loss"] for m in plain[0]] == [m["loss"] for m in remat[0]]
    assert remat[2].module.visual.transformer.remat
    for (k, a), (_, b) in zip(plain[2].module.named_parameters(),
                              remat[2].module.named_parameters()):
        assert torch.equal(a, b), k


def test_label_text_variant_matches_jax(runs):
    """The vision tower trained under ``ClipVideoTextIdentity`` against
    label-text features passed in (the text tower never trains on any
    path): losses and every leaf as above; ``logit_scale`` and the vision
    tower get gradients, the text tower none."""
    run_ = runs["text"]
    jm, jsd = run_["jax"]
    pm = run_["port"][0]
    for k in range(STEPS):
        assert pm[k]["loss"] == pytest.approx(jm[k]["loss"], rel=1e-5)
    zero = _hold_leaves(run_["cfg"], run_["port"], jsd)
    assert "logit_scale" not in zero
    assert zero and all(not k.startswith("visual.") for k in zero)
    assert run_["port"][2].module.head is None


def test_taps_buffer_carries_the_gradient():
    """The taps written into one buffer under autograd give each block's
    parameters the gradient a stack of the outputs gives (fp32, the
    buffer's backward sums in another order: rtol 1e-5)."""
    torch.manual_seed(0)
    tower = Transformer(16, 3, 1)
    for p in tower.parameters():
        torch.nn.init.normal_(p, std=0.2)
    x = torch.randn(2, 5, 16)
    w = torch.randn(3, 2, 5, 16)
    _, taps = tower(x, collect_taps=True)
    got = torch.autograd.grad((taps * w).sum(), list(tower.parameters()))
    outs, y = [], x
    for block in tower.resblocks:
        y = block(y)
        outs.append(y)
    want = torch.autograd.grad((torch.stack(outs) * w).sum(),
                               list(tower.parameters()))
    for g, h in zip(got, want):
        torch.testing.assert_close(g, h, rtol=1e-5, atol=1e-6)


def test_pyth_save_and_resume_bit_for_bit(repo_root, tmp_path):
    """One step, a ``.pyth`` checkpoint (the head's weights in it), an
    auto-resume into a model from another seed, then one more step on
    both: the same loss and weights bit for bit."""
    cfg, _ = _cfgs(repo_root, "OUTPUT_DIR", str(tmp_path),
                   "TRAIN.AUTO_RESUME", "true")
    batches = _batches(text=False)

    def fresh(seed):
        model = build_model(cfg, device="cpu", seed=seed)
        optimizer, lr_fn = popt.construct_optimizer(cfg, model.module, SPE)
        state = create_train_state(model, optimizer, None)
        return state, make_train_step(model, cfg, optimizer, lr_fn)

    def tb(b):
        return {"video": torch.from_numpy(b["video"]),
                "labels": torch.from_numpy(b["labels"]).long()}

    state, step = fresh(0)
    step(state, tb(batches[0]))
    path = cu.save_checkpoint(cfg, state, 0, iter_in_epoch=1)
    saved = torch.load(path, weights_only=False)["model_state"]
    assert {"head.out.weight", "head.out.bias", "visual.proj",
            "token_embedding.weight"} <= set(saved)
    other, other_step = fresh(1)
    other, _, start_iter = cu.load_train_checkpoint(cfg, other)
    assert start_iter == 1 and other.step == state.step
    a = step(state, tb(batches[1]))["loss"]
    b = other_step(other, tb(batches[1]))["loss"]
    assert torch.equal(a, b)
    for (k, p), (_, q) in zip(state.model.module.named_parameters(),
                              other.model.module.named_parameters()):
        assert torch.equal(p, q), k


def test_fine_tune_init_and_pretrained_weights(repo_root, tmp_path):
    """A fine-tune init from a ``.pyth`` (``TRAIN.CHECKPOINT_FILE_PATH``)
    loads every weight, the head's too, at step 0; a released-layout CLIP
    file at ``PRETRAIN_WEIGHT_PATH`` loads into the towers (the
    reference's names, no rename) and leaves the head as drawn."""
    from dist_tpu_torch.tasks.state import load_pretrained

    cfg, _ = _cfgs(repo_root)
    src = _port_model(cfg, _variables())
    path = str(tmp_path / "ft.pyth")
    torch.save({"model_state": src.module.state_dict()}, path)
    ft, _ = _cfgs(repo_root, "OUTPUT_DIR", str(tmp_path / "run"),
                  "TRAIN.CHECKPOINT_FILE_PATH", path)
    model = build_model(ft, device="cpu", seed=1)
    optimizer, _ = popt.construct_optimizer(ft, model.module, SPE)
    state, epoch, it = cu.load_train_checkpoint(
        ft, create_train_state(model, optimizer, None))
    assert (epoch, it, state.step) == (0, 0, 0)
    for k, v in src.module.state_dict().items():
        assert torch.equal(model.module.state_dict()[k], v), k

    clip = {k: v for k, v in src.module.state_dict().items()
            if not k.startswith("head.")}
    weights = str(tmp_path / "ViT-Test.pt")
    torch.save(clip, weights)
    pre, _ = _cfgs(repo_root, "VIDEO.BACKBONE.LOCAL_PRETRAIN_WEIGHT_PATH",
                   weights)
    model = build_model(pre, device="cpu", seed=1)
    head = model.module.head.out.weight.detach().clone()
    load_pretrained(pre, model)
    for k, v in clip.items():
        assert torch.equal(model.module.state_dict()[k], v), k
    assert torch.equal(model.module.head.out.weight, head)


def test_ddp_world_1_and_ema_equal_the_plain_steps(repo_root, tmp_path):
    """Two steps through ``DistributedDataParallel`` (a gloo group of one
    rank in this process; ``find_unused_parameters`` for the text tower,
    which no loss reaches here) with an EMA copy: the losses, weights and
    EMA equal the plain steps' bit for bit."""
    from dist_tpu_torch.parallel.mesh import wrap_ddp

    cfg, _ = _cfgs(repo_root, "MODEL.EMA.ENABLE", "true",
                   "MODEL.EMA.DECAY", "0.9")
    b = _batches(text=False)[0]
    batch = {"video": torch.from_numpy(b["video"]),
             "labels": torch.from_numpy(b["labels"]).long()}
    out = []
    for ddp in (False, True):
        model = _port_model(cfg, _variables())
        optimizer, lr_fn = popt.construct_optimizer(cfg, model.module, SPE)
        state = create_train_state(model, optimizer, 0.9)
        try:
            if ddp:
                torch.distributed.init_process_group(
                    "gloo", init_method=f"file://{tmp_path / 'store'}",
                    world_size=1, rank=0)
                wrap_ddp(model)
            step = make_train_step(model, cfg, optimizer, lr_fn)
            losses = [step(state, batch)["loss"] for _ in range(2)]
        finally:
            if ddp:
                torch.distributed.destroy_process_group()
        out.append((losses, model.module.state_dict(), state.ema))
    (la, wa, ea), (lb, wb, eb) = out
    assert [float(v) for v in la] == [float(v) for v in lb]
    assert "head.out.weight" in ea
    for k in wa:
        assert torch.equal(wa[k], wb[k]) and torch.equal(ea[k], eb[k]), k


def test_engine_serves_the_linear_head(repo_root):
    """``InferenceEngine`` on the CPU: softmax rows over the 174 classes,
    equal to the eval step's, with no label-text features."""
    from dist_tpu_torch.serving.engine import InferenceEngine

    cfg, _ = _cfgs(repo_root)
    engine = InferenceEngine(cfg, batch_size=2, device="cpu")
    assert engine.text_features is None
    clips = _batches(text=False)[0]["video"]
    scores = engine.predict(clips)
    assert scores.shape == (B, CLASSES)
    np.testing.assert_allclose(scores.sum(axis=1), 1.0, rtol=1e-5)
    want = make_eval_step(engine.model, cfg)(
        {"video": torch.from_numpy(clips)})["preds"]
    np.testing.assert_array_equal(scores, want.numpy())


RUN_OPTS = TINY + [
    "VIDEO.HEAD.NUM_CLASSES", "12", "DATA.SYNTHETIC", "true",
    "TRAIN.BATCH_SIZE", "2", "TEST.BATCH_SIZE", "2",
    "TRAIN.NUM_SAMPLES_LIMIT", "4", "TEST.NUM_SAMPLES_LIMIT", "2",
    "OPTIMIZER.MAX_EPOCH", "2", "TRAIN.NUM_FOLDS", "1",
    "OPTIMIZER.WARMUP_EPOCHS", "1", "TRAIN.CHECKPOINT_PERIOD", "1",
    "TRAIN.EVAL_PERIOD", "1", "DATA_LOADER.NUM_WORKERS", "0",
    "LOG_MODEL_INFO", "false", "LOG_CONFIG_INFO", "false"]


def test_tiny_run_list(repo_root, tmp_path, capfd):
    """train (2 epochs of 2 steps in bf16 with mixup, cutmix and dropout
    as shipped, a val eval and a checkpoint after each) -> test -> the
    multi-view test: every view counted once, finite scores; the missing
    pretrained weights are logged and skipped."""
    results = run.main(["--cfg", os.path.join(repo_root, CFG),
                        "--device", "cpu", *RUN_OPTS,
                        "OUTPUT_DIR", str(tmp_path)])
    state, tests = results[0], results[1:]
    assert state.step == 4
    assert "ViT-B-16.pt not found" in "".join(capfd.readouterr())
    assert str(state.model.module.dtype) == "torch.bfloat16"
    names = sorted(os.listdir(tmp_path / "checkpoints"))
    assert [n for n in names if n.endswith(".pyth")] == [
        "checkpoint_epoch_00001.pyth", "checkpoint_epoch_00002.pyth"]
    assert tests
    for meter in tests:
        assert (meter.clip_count == meter.num_clips).all() and meter.seen.all()
        assert np.isfinite(meter.video_preds).all()
