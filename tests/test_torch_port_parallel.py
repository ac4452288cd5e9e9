"""The port's data axis and host collectives (``dist_tpu_torch/parallel/``)
against the JAX package's ``parallel/mesh.py`` and
``parallel/collectives.py``, on the CPU: the data axis and its refusals
over a table of configs and worlds, the launcher's choice of ranks and
backend, and the collectives at world 1 (no group: the identity) and at
world 2 (two gloo ranks spawned through the port's own launcher, with a
``file://`` store), mirroring ``tests/mp_worker.py``'s checks."""

import os

import numpy as np
import pytest
import torch

import jax

from dist_tpu.config import load_config as jax_load_config
from dist_tpu.parallel.mesh import build_mesh, config_data_axis_size
from dist_tpu_torch.config import load_config
from dist_tpu_torch.parallel import collectives as C
from dist_tpu_torch.parallel import launch, mesh
from tests import torch_ddp_ranks

TINY = "configs/projects/dist/test/tiny_synth.yaml"
POD8 = "configs/projects/dist/ssv2/vit-l14-32+64f-pod8.yaml"
# a spawned group's time limit: a hung rendezvous fails its test
SPAWN_TIMEOUT_S = 120


def _cfgs(repo_root, path, opts):
    path = os.path.join(repo_root, path)
    return (load_config(path, opts, make_output_dir=False),
            jax_load_config(path, opts, make_output_dir=False))


def _jax_axis(jcfg, world):
    """JAX's data axis on ``world`` devices, or the refusal's type."""
    try:
        m = build_mesh(jcfg, devices=jax.devices()[:world])
    except AssertionError:
        return AssertionError
    assert m.shape["data"] == config_data_axis_size(jcfg, world)
    return m.shape["data"]


@pytest.mark.parametrize("path,opts", [
    (TINY, []), (TINY, ["TPU.MESH.DATA", "1"]), (TINY, ["TPU.MESH.DATA", "2"]),
    (TINY, ["TPU.MESH.DATA", "4"]), (TINY, ["TPU.MESH.DATA", "8"]),
    (POD8, [])])
@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_data_axis_matches_jax(repo_root, path, opts, world):
    """One rank per device: the port's data axis is JAX's on as many
    devices, and a config JAX's ``build_mesh`` refuses the port refuses."""
    cfg, jcfg = _cfgs(repo_root, path, opts)
    want = _jax_axis(jcfg, world)
    if want is AssertionError:
        with pytest.raises(ValueError, match="TPU.MESH"):
            mesh.data_axis_size(cfg, world)
    else:
        assert mesh.data_axis_size(cfg, world) == want == world


@pytest.mark.parametrize("opts,world", [
    (["TPU.MESH.MODEL", "2", "TPU.MESH.PIPE", "2"], 4),
    (["TPU.MESH.MODEL", "2", "TPU.MESH.DATA", "3"], 4)])
def test_model_and_pipe_axes_are_refused(repo_root, opts, world):
    """What JAX's ``build_mesh`` refuses, the port refuses: a pipe axis
    with a model axis (not composed), and an explicit data axis that
    does not tile the ranks with the model axis. The axes alone run:
    ``test_model_and_pipe_axes_match_jax``."""
    cfg, jcfg = _cfgs(repo_root, TINY, opts)
    assert _jax_axis(jcfg, world) is AssertionError
    with pytest.raises(ValueError, match="TPU.MESH"):
        mesh.data_axis_size(cfg, world)
    if "TPU.MESH.PIPE" in opts:     # refused whatever the world
        with pytest.raises(ValueError, match="TPU.MESH"):
            mesh.requested_world(cfg, "cpu")


@pytest.mark.parametrize("opts", [
    ["TPU.MESH.MODEL", "2"], ["TPU.MESH.PIPE", "2"],
    ["TPU.MESH.MODEL", "4"], ["TPU.MESH.PIPE", "2", "TPU.MESH.DATA", "4"]])
@pytest.mark.parametrize("world", [2, 4, 8])
def test_model_and_pipe_axes_match_jax(repo_root, opts, world):
    """The model and pipe axes take ranks from the data axis as JAX's mesh
    takes devices: the port's data axis is JAX's on as many devices, and
    a world JAX refuses the port refuses. Without ``torchrun`` the launch
    on the CPU starts one data shard's ranks unless the data axis is
    explicit."""
    cfg, jcfg = _cfgs(repo_root, TINY, opts)
    want = _jax_axis(jcfg, world)
    if want is AssertionError:
        with pytest.raises(ValueError, match="TPU.MESH"):
            mesh.data_axis_size(cfg, world)
    else:
        assert mesh.data_axis_size(cfg, world) == want
    data, pipe, model = mesh._mesh_shape_cfg(cfg)
    assert mesh.requested_world(cfg, "cpu") == (
        data if data > 0 else 1) * pipe * model


def test_requested_world_and_backend(repo_root, monkeypatch):
    """Without torchrun: an explicit TPU.MESH.DATA, else every local card
    for the default device, else one rank. DIST_BACKEND xla (the config
    tree's) is NCCL on CUDA and gloo on the CPU; gloo is honoured."""
    cfg, _ = _cfgs(repo_root, TINY, [])
    assert cfg.DIST_BACKEND == "xla"
    assert mesh.requested_world(cfg, "cpu") == 1
    assert mesh.requested_world(cfg, "cuda:0") == 1
    two, _ = _cfgs(repo_root, TINY, ["TPU.MESH.DATA", "2"])
    assert mesh.requested_world(two, "cpu") == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert mesh.requested_world(cfg, None) == 4
    assert mesh.backend(cfg, torch.device("cuda", 0)) == "nccl"
    assert mesh.backend(cfg, torch.device("cpu")) == "gloo"
    gloo, _ = _cfgs(repo_root, TINY, ["DIST_BACKEND", "gloo"])
    assert mesh.backend(gloo, torch.device("cuda", 0)) == "gloo"
    nccl, _ = _cfgs(repo_root, TINY, ["DIST_BACKEND", "nccl"])
    with pytest.raises(ValueError, match="nccl"):
        mesh.backend(nccl, torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.requested_world(cfg, None)


def test_collectives_outside_a_group_are_the_identity():
    a, b = np.arange(3), np.ones((2, 2))
    got = C.all_gather_arrays(a, b)
    assert got[0] is a and got[1] is b
    assert C.all_reduce_mean(1, 2.5) == [1.0, 2.5]
    assert C.any_flag(True) and not C.any_flag(False)
    assert C.broadcast_from_master("x") == "x"
    assert (C.get_rank(), C.get_world_size(), C.is_master_proc()) == (0, 1,
                                                                     True)
    C.synchronize()


def test_collectives_at_world_2(repo_root):
    cfg, _ = _cfgs(repo_root, TINY, ["TPU.MESH.DATA", "2"])
    outs = launch.launch_task(cfg, torch_ddp_ranks.collectives_checks,
                              device="cpu", timeout=SPAWN_TIMEOUT_S)
    ids = np.concatenate([np.arange(2), np.arange(3) + 10])
    for rank, out in enumerate(outs):
        assert (out["rank"], out["world"], out["master"]) == (rank, 2,
                                                              rank == 0)
        g_ids, g_rows = out["gathered"]
        np.testing.assert_array_equal(g_ids, ids)
        assert g_rows.shape == (5, 2) and g_rows[:2].sum() == 0
        assert g_rows[2:].sum() == 6
        assert out["mean"] == [0.5, 3.0]
        assert out["any_rank1"] is True and out["any_none"] is False
        assert int(out["broadcast"][0]) == 42


def test_a_failing_rank_fails_the_launch(repo_root):
    """A rank that raises fails the launch with its traceback, and the
    other rank, blocked in a collective, is stopped."""
    cfg, _ = _cfgs(repo_root, TINY, ["TPU.MESH.DATA", "2"])
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        launch.launch_task(cfg, torch_ddp_ranks.rank1_fails, device="cpu",
                           timeout=SPAWN_TIMEOUT_S)


def test_ranks_that_exit_end_the_launch_alike(repo_root):
    """Both ranks leave through ``SystemExit(0)`` (a preemption's exit):
    the launch ends with the same ``SystemExit``."""
    cfg, _ = _cfgs(repo_root, TINY, ["TPU.MESH.DATA", "2"])
    with pytest.raises(SystemExit) as e:
        launch.launch_task(cfg, torch_ddp_ranks.both_exit, device="cpu",
                           timeout=SPAWN_TIMEOUT_S)
    assert e.value.code == 0


def test_adjust_lr_scales_by_the_data_axis(repo_root, monkeypatch):
    """Under ``OPTIMIZER.ADJUST_LR`` the LR scales by the global batch,
    ``TRAIN.BATCH_SIZE`` times the data axis: at world 2 the JAX
    package's rule with a data axis of 2."""
    from dist_tpu.optim import optimizer as jopt
    from dist_tpu_torch.optim import optimizer

    opts = ["OPTIMIZER.ADJUST_LR", "true", "TRAIN.BATCH_SIZE", "16",
            "TPU.MESH.DATA", "2"]
    cfg, jcfg = _cfgs(repo_root, TINY, opts)
    monkeypatch.setattr(C, "get_world_size", lambda: 2)
    assert optimizer.base_lr(cfg) == pytest.approx(jopt.base_lr(jcfg),
                                                   rel=1e-12)
    assert optimizer.base_lr(cfg) == pytest.approx(
        float(cfg.OPTIMIZER.BASE_LR) * 32 / 256, rel=1e-12)
