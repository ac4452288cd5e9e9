"""``TPU.FSDP`` (ZeRO-3 over the data axis, ``parallel/fsdp.py``) at world
2 on the CPU: two gloo ranks spawned once for the file through the
port's launcher, on the step geometry of ``test_torch_port_ddp.py``
(``tiny_synth.yaml`` in fp32, the TemporalNet fused, EMA on), rank r on
rows [4r, 4r + 4) of one global batch of 8.

- Three train steps against the one-process run at the same global batch
  and against the JAX package's step with ``shard_params(fsdp=True)`` on
  its 8-device mesh; each rank holds half the parameters and moments.
- The evals after each step (plain and EMA) against the one process's;
  with FSDP2's freed storage kept at its address (as the CUDA caching
  allocator hands a block back), K2's pack cache keyed on address and
  version gives a stale pack, and packing every call does not.
- The checkpoint: the file FSDP writes is the replicated run's (full
  tensors, the same keys), a plain state resumes it and writes it again
  bit for bit, FSDP resumes the plain one's file, and the model exports
  from it."""

import os

import numpy as np
import pytest
import torch

from dist_tpu_torch.config import load_config
from dist_tpu_torch.models.clip.convert import state_dict_from_jax
from dist_tpu_torch.parallel import launch
from tests import torch_parallel_ranks as R
from tests.test_torch_port_ddp import (
    STEP,
    TINY,
    _jax_step,
    _step_inputs,
)

SPAWN_TIMEOUT_S = 600
STEPS = 3
FSDP = ["TPU.FSDP", "true", "TPU.MESH.DATA", "2"]
FUSED = ["TPU.FUSED_TEMPORAL_NET", "true"]
# fp32 in another summation order: the losses, the gradients (of each
# leaf's largest value) and the scores
LOSS_REL = 1e-5
GRAD_REL = 1e-5
SCORE_ATOL = 1e-5


def _travel(jcfg, lr):
    """AdamW's largest step of an element, and the bound on one step's
    difference where a near-zero gradient's sign flips (the DDP test's)."""
    b1, b2 = jcfg.OPTIMIZER.BETAS
    travel = lr * float(jcfg.OPTIMIZER.NEW_NET_LRMULT)
    return travel, 2 * (1 - b1) / np.sqrt(1 - b2) * travel


@pytest.fixture(scope="module")
def few_threads():
    """Two intra-op threads in this process while the file's fixture runs
    (the spawned ranks share them: one each): the suite runs in several
    worker processes at once, and every core in each of them would
    oversubscribe the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(repo_root, tmp_path_factory, few_threads):
    jcfg, params, batch = _step_inputs(repo_root)
    weights = {k: np.asarray(v, np.float32)
               for k, v in state_dict_from_jax(params).items()}
    path = os.path.join(repo_root, TINY)
    cfg = load_config(path, STEP + FUSED + FSDP, make_output_dir=False)
    plain_cfg = load_config(path, STEP + FUSED, make_output_dir=False)
    out = str(tmp_path_factory.mktemp("fsdp"))
    one = R.train_steps(plain_cfg, weights, batch, STEPS,
                        os.path.join(out, "one"), evals=True)
    group = launch.launch_task(
        cfg, R.fsdp_group, (cfg, plain_cfg, weights, batch, STEPS, out),
        device="cpu", timeout=SPAWN_TIMEOUT_S)
    pack_ref = R.pack_evals(plain_cfg, weights, batch, "shipped")
    return {"one": one, "group": group, "jax": _jax_step(jcfg, params, batch,
                                                         fsdp=True),
            "jcfg": jcfg, "weights": weights, "pack_ref": pack_ref,
            "batch": batch}


def test_fsdp_matches_the_one_process_run(runs):
    """Each step's loss and the evals after it; the weights after three
    steps within three steps of AdamW's flip bound; both ranks alike."""
    one, (r0, r1) = runs["one"], [g["fsdp"] for g in runs["group"]]
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=LOSS_REL)
    assert r0["losses"] == r1["losses"]
    for got, want in zip(r0["evals"] + r0["ema_evals"],
                         one["evals"] + one["ema_evals"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
    _, flip = _travel(runs["jcfg"], runs["jax"][3])
    for k, w in one["weights"].items():
        np.testing.assert_array_equal(r0["weights"][k], r1["weights"][k], k)
        assert np.abs(r0["weights"][k] - w).max() <= STEPS * flip, k


def test_fsdp_step_matches_jax_fsdp(runs):
    """The first step against JAX's step with the state placed by
    ``shard_params(fsdp=True)``: the loss, every dist_net gradient and the
    weights after it (the DDP test's tolerances)."""
    loss, grads, after, lr = runs["jax"]
    got = runs["group"][0]["fsdp"]
    assert got["losses"][0] == pytest.approx(loss, rel=LOSS_REL)
    assert got["grads"] and all(k.startswith("dist_net.") or k.startswith(
        "head.") for k in got["grads"])
    travel, flip = _travel(runs["jcfg"], lr)
    for name, g in got["grads"].items():
        want = grads[name]
        np.testing.assert_allclose(
            g, want, rtol=0, err_msg=name,
            atol=GRAD_REL * float(np.abs(want).max()) + 1e-12)
        steady = np.abs(want) >= 1e-3 * np.abs(want).max()
        err = np.abs(got["first_weights"][name] - after[name])
        assert (err[steady] <= 1e-6 + 0.01 * travel).all(), name
        assert (err <= flip).all(), name


def test_fsdp_holds_a_share_of_the_state(runs):
    """About half the parameters and of AdamW's moments a rank: the two
    ranks' shards add up to the whole, CLIP's 0-d logit_scale (which
    FSDP2 does not shard) held by both, and neither holds more than
    55 %."""
    one = runs["one"]
    ranks = [g["fsdp"] for g in runs["group"]]
    total = one["total_params"]
    assert one["local_params"] == total
    assert all(r["total_params"] == total for r in ranks)
    assert sum(r["local_params"] for r in ranks) == total + 1
    moments = sum(r["local_moments"] for r in ranks)
    assert one["local_moments"] <= moments <= one["local_moments"] + 2
    for r in ranks:
        assert r["local_params"] <= 0.55 * total
        assert r["local_moments"] <= 0.55 * one["local_moments"]


def test_unused_ladder_module_gets_a_zero_gradient(runs):
    """The last ladder step's ``integration2temporal_nets`` never reaches
    the loss: FSDP2 reduces no gradient for it, and the step gives it the
    zero gradient JAX's ``grad`` gives it."""
    grads = runs["group"][0]["fsdp"]["grads"]
    jax_grads = runs["jax"][1]
    last = [k for k in grads if k.startswith(
        "dist_net.integration2temporal_nets.1.")]
    assert last
    for k in last:
        assert not grads[k].any() and not jax_grads[k].any(), k


def test_pack_cache_under_fsdp(runs):
    """An eval, an EMA eval (another model's weights), an eval again under
    FSDP with its storage kept at one address: as shipped (the TemporalNet
    packs every call under FSDP) each equals the one process's; with the
    cache keyed on address and version (the control) the EMA eval reuses
    the first eval's pack."""
    ref = runs["pack_ref"]
    for g in runs["group"]:
        for got, want in zip(g["pack"]["shipped"], ref):
            np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
        stale = g["pack"]["cached"]
        assert np.abs(stale[1] - ref[1]).max() > 10 * SCORE_ATOL
        np.testing.assert_allclose(stale[0], ref[0], rtol=0, atol=SCORE_ATOL)


def test_checkpoint_round_trip(runs):
    """FSDP's file is the one process's: the same keys and shapes, full
    tensors, the optimizer's state under the same ids; a plain state
    resumes it and writes the same file bit for bit; FSDP resumes the
    plain file to the state it saved."""
    g = runs["group"][0]
    fsdp = torch.load(g["fsdp"]["checkpoint"], weights_only=True)
    one = torch.load(runs["one"]["checkpoint"], weights_only=True)
    plain = torch.load(g["plain_checkpoint"], weights_only=True)
    assert sorted(fsdp) == sorted(one) == sorted(plain)
    _, flip = _travel(runs["jcfg"], runs["jax"][3])
    for key in ("model_state", "ema"):
        assert {k: v.shape for k, v in fsdp[key].items()} == {
            k: v.shape for k, v in one[key].items()}
        for k, v in fsdp[key].items():
            assert not hasattr(v, "to_local"), k
            assert (v - one[key][k]).abs().max() <= STEPS * flip, k
            assert torch.equal(v, plain[key][k]), k
    opt, popt = fsdp["optimizer_state"], one["optimizer_state"]
    assert opt["param_groups"] == popt["param_groups"]
    assert sorted(opt["state"]) == sorted(popt["state"])
    for i, entry in opt["state"].items():
        for k, v in entry.items():
            assert v.shape == popt["state"][i][k].shape, (i, k)
            assert torch.equal(v, plain["optimizer_state"]["state"][i][k])
    resumed = g["resumed"]
    assert resumed["step"] == fsdp["step"] == STEPS
    for k, v in fsdp["model_state"].items():
        np.testing.assert_array_equal(resumed["weights"][k], v.numpy(), k)
        np.testing.assert_array_equal(resumed["ema"][k], fsdp["ema"][k]
                                      .numpy(), k)
    for i, entry in opt["state"].items():
        for k, v in entry.items():
            np.testing.assert_array_equal(
                resumed["optimizer"]["state"][i][k], v.numpy())


def test_model_trained_under_fsdp_exports(repo_root, runs):
    """``serving/export.py`` forces ``TPU.FSDP`` off, so the checkpoint
    written under FSDP (its gathered weights) exports as it is: the
    program's scores are those of the engine on the same file."""
    from dist_tpu_torch.serving import export
    from dist_tpu_torch.serving.engine import InferenceEngine

    ckpt = ["TEST.CHECKPOINT_FILE_PATH",
            runs["group"][0]["fsdp"]["checkpoint"]]
    path = os.path.join(repo_root, TINY)
    cfg = load_config(path, STEP + FUSED + FSDP + ckpt, make_output_dir=False)
    program, _ = export.export_predictor(cfg, batch_size=2, device="cpu")
    clips = runs["batch"]["video"][:2]
    with torch.no_grad():
        got = program.module()(torch.from_numpy(clips)).numpy()
    engine = InferenceEngine(load_config(path, STEP + FUSED + ckpt,
                                         make_output_dir=False),
                             batch_size=2, device="cpu")
    np.testing.assert_allclose(got, engine.predict(clips), rtol=0,
                               atol=SCORE_ATOL)
