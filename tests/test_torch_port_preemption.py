"""Checkpoints, auto-resume and preemption of the port's train run: the
counterparts of ``tests/test_preemption.py`` and of the resume, fold-grid
and val-padding tests of ``tests/test_e2e.py``, on ``tiny_synth.yaml`` at
batch 8 (two batches per fold-epoch) on the CPU.

SIGTERM, or ``TRAIN.PREEMPT_AFTER_ITERS``, drains the step in flight,
writes a mid-epoch ``.pyth`` carrying (epoch, iter) and exits through
``SystemExit(0)``; a resume skips exactly the consumed prefix of the batch
stream, and the step's mixup draws are a function of its step count, so
the resumed run equals the uninterrupted one bit for bit (mixup and
cutmix on, bf16, EMA on). Beside them: the EMA setting toggled between a
save and its resume, the SIGTERM disposition restored after ``train``,
an ``OUTPUT_DIR`` holding only the JAX package's Orbax directories
refused, the entry point's need of a card, and its refusal of a process
count other than the config's data axis."""

import os
import signal

import numpy as np
import pytest
import torch

from dist_tpu_torch.config import load_config
from dist_tpu_torch.data.builder import build_loader
from dist_tpu_torch.models.base.models import build_model
from dist_tpu_torch.optim.optimizer import construct_optimizer
from dist_tpu_torch.tasks import train as train_task
from dist_tpu_torch.tasks.state import (
    compute_text_features,
    create_train_state,
    make_eval_step,
)
from dist_tpu_torch.utils import checkpoint as cu
from dist_tpu_torch.utils.meters import ValMeter

TINY = "configs/projects/dist/test/tiny_synth.yaml"
RESUME = ["OPTIMIZER.MAX_EPOCH", "2", "TRAIN.AUTO_RESUME", "true",
          "MODEL.EMA.ENABLE", "true", "MODEL.EMA.DECAY", "0.9"]


def _cfg(repo_root, out, *opts):
    return load_config(os.path.join(repo_root, TINY),
                       ["TRAIN.BATCH_SIZE", "8", "TEST.BATCH_SIZE", "8",
                        "OUTPUT_DIR", str(out), *opts])


def _state(cfg, step=0):
    model = build_model(cfg, device="cpu")
    optimizer, _ = construct_optimizer(cfg, model.module, 2)
    ema = float(cfg.MODEL.EMA.DECAY) if cfg.MODEL.EMA.ENABLE else None
    state = create_train_state(model, optimizer, ema)
    state.step = step
    return state


def _weights(state):
    return {k: v.detach().clone()
            for k, v in state.model.module.state_dict().items()}


def _names(cfg):
    d = cu.checkpoint_dir(cfg)
    return sorted(n for n in os.listdir(d) if n.endswith(".pyth"))


def _assert_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   msg=k)


def test_loader_skip_batches_matches_full_stream(repo_root, tmp_path):
    """``set_skip_batches(n)`` gives the tail of the same epoch's stream,
    once: the next epoch is whole again."""
    loader = build_loader(_cfg(repo_root, tmp_path), "train", device="cpu")
    loader.set_epoch(0)
    full = [b["label"] for b in loader]
    assert len(full) == 2
    loader.set_epoch(0)
    loader.set_skip_batches(1)
    tail = [b["label"] for b in loader]
    assert len(tail) == 1
    np.testing.assert_array_equal(tail[0], full[1])
    assert len(list(loader)) == 2


def test_mid_epoch_checkpoint_roundtrip(repo_root, tmp_path):
    """A mid-epoch save stores (cur_epoch, iter), sorts after the
    start-of-epoch checkpoint, and ``load_train_checkpoint`` restores the
    weights, the optimizer, the EMA copy and the step."""
    cfg = _cfg(repo_root, tmp_path, "TRAIN.NUM_FOLDS", "2",
               "OPTIMIZER.MAX_EPOCH", "10", *RESUME[2:])
    state = _state(cfg, step=5)
    cu.save_checkpoint(cfg, state, cur_epoch=0)  # end of fold-epoch 0 -> 2
    with torch.no_grad():
        for p in state.model.module.parameters():
            p.add_(1.0)
    state.step = 8
    first = state.optimizer.param_groups[0]["params"][0]
    state.optimizer.state[first] = {"step": torch.tensor(8.0),
                                    "exp_avg": torch.ones_like(first)}
    want = _weights(state)
    cu.save_checkpoint(cfg, state, cur_epoch=2, iter_in_epoch=3)
    assert cu.get_last_checkpoint(cfg).endswith(
        "checkpoint_epoch_00002_iter_0000003.pyth")
    fresh = _state(cfg)
    restored, start_epoch, start_iter = cu.load_train_checkpoint(cfg, fresh)
    assert (start_epoch, start_iter) == (2, 3) and restored.step == 8
    _assert_equal(_weights(restored), want)
    _assert_equal(restored.ema, state.ema)
    _assert_equal(restored.optimizer.state_dict()["state"][0],
                  {"step": torch.tensor(8.0),
                   "exp_avg": torch.ones_like(first)})
    # the fold grid still holds on resume
    assert (cfg.OPTIMIZER.MAX_EPOCH - start_epoch) % 2 == 0


def test_mid_epoch_resume_rejects_changed_loader_geometry(repo_root,
                                                          tmp_path):
    """A mid-epoch checkpoint records the loader signature; a resume with
    another batch size restarts the fold-epoch from iter 0."""
    cfg = _cfg(repo_root, tmp_path, "TRAIN.AUTO_RESUME", "true")
    cu.save_checkpoint(cfg, _state(cfg, 3), cur_epoch=0, iter_in_epoch=5,
                       dataset_len=16)
    _, epoch, start_iter = cu.load_train_checkpoint(cfg, _state(cfg),
                                                    dataset_len=16)
    assert (epoch, start_iter) == (0, 5)
    for opts, n in ((["TRAIN.BATCH_SIZE", "4"], 16), ([], 13)):
        changed = _cfg(repo_root, tmp_path, "TRAIN.AUTO_RESUME", "true",
                       *opts)
        _, epoch, start_iter = cu.load_train_checkpoint(
            changed, _state(changed), dataset_len=n)
        assert (epoch, start_iter) == (0, 0)


def test_async_checkpoint_commit(repo_root, tmp_path):
    """``TRAIN.CHECKPOINT_ASYNC``: the save copies the state to the host
    at once, so changing it afterwards does not reach the file, and
    ``wait_until_finished`` makes the file durable."""
    cfg = _cfg(repo_root, tmp_path, "TRAIN.CHECKPOINT_ASYNC", "true",
               "TRAIN.AUTO_RESUME", "true")
    state = _state(cfg, step=4)
    want = _weights(state)
    path = cu.save_checkpoint(cfg, state, cur_epoch=0)
    with torch.no_grad():
        for p in state.model.module.parameters():
            p.zero_()
    cu.wait_until_finished()
    assert os.path.isfile(path) and os.path.isfile(path + ".config.yaml")
    restored, start_epoch, start_iter = cu.load_train_checkpoint(
        cfg, _state(cfg))
    assert (start_epoch, start_iter, restored.step) == (1, 0, 4)
    _assert_equal(_weights(restored), want)


def test_checkpoint_retention_keeps_last_n(repo_root, tmp_path):
    """``TRAIN.CHECKPOINT_KEEP_LAST`` prunes all but the newest N after
    each save, by (epoch, iter); mid-epoch saves take part."""
    cfg = _cfg(repo_root, tmp_path, "TRAIN.CHECKPOINT_KEEP_LAST", "2",
               "TRAIN.AUTO_RESUME", "true")
    state = _state(cfg)
    for epoch in range(4):
        cu.save_checkpoint(cfg, state, cur_epoch=epoch)
    assert _names(cfg) == ["checkpoint_epoch_00003.pyth",
                           "checkpoint_epoch_00004.pyth"]
    _, start_epoch, _ = cu.load_train_checkpoint(cfg, _state(cfg))
    assert start_epoch == 4
    cu.save_checkpoint(cfg, state, cur_epoch=4, iter_in_epoch=1)
    assert _names(cfg) == ["checkpoint_epoch_00004.pyth",
                           "checkpoint_epoch_00004_iter_0000001.pyth"]


def test_async_retention_never_drops_below_keep(repo_root, tmp_path):
    """Async + KEEP_LAST: retention runs before the new save is issued, so
    the newest KEEP_LAST committed checkpoints stay while it is in
    flight."""
    cfg = _cfg(repo_root, tmp_path, "TRAIN.CHECKPOINT_ASYNC", "true",
               "TRAIN.CHECKPOINT_KEEP_LAST", "1")
    state = _state(cfg)
    for epoch, want in ((0, [1]), (1, [1, 2]), (2, [2, 3])):
        cu.save_checkpoint(cfg, state, cur_epoch=epoch)
        cu.wait_until_finished()
        assert _names(cfg) == [f"checkpoint_epoch_{e:05d}.pyth" for e in want]


def test_retention_sweeps_orphan_sidecars(repo_root, tmp_path):
    """A sidecar whose checkpoint is gone (an async save that died before
    its commit) is removed; a live checkpoint's stays."""
    cfg = _cfg(repo_root, tmp_path, "TRAIN.CHECKPOINT_KEEP_LAST", "2")
    cu.save_checkpoint(cfg, _state(cfg), cur_epoch=0)
    d = cu.checkpoint_dir(cfg)
    orphan = os.path.join(d, "checkpoint_epoch_00099.pyth.config.yaml")
    with open(orphan, "w") as f:
        f.write("{}\n")
    cu.prune_old_checkpoints(cfg)
    assert not os.path.exists(orphan)
    assert os.path.exists(os.path.join(d, "checkpoint_epoch_00001.pyth"
                                       ".config.yaml"))


def test_preempt_at_epoch_final_step_saves_end_of_epoch(repo_root, tmp_path):
    """A preemption caught at a fold-epoch's last step saves an
    end-of-epoch checkpoint, and the resume completes the run."""
    opts = RESUME + ["TEST.ENABLE", "false"]
    with pytest.raises(SystemExit) as e:
        train_task.train(_cfg(repo_root, tmp_path, *opts,
                              "TRAIN.PREEMPT_AFTER_ITERS", "2"),
                         device="cpu")
    assert e.value.code == 0
    cfg = _cfg(repo_root, tmp_path, *opts)
    assert cu.get_last_checkpoint(cfg).endswith("checkpoint_epoch_00001.pyth")
    assert train_task.train(cfg, device="cpu").step == 4


@pytest.fixture(scope="module")
def uninterrupted(repo_root, tmp_path_factory):
    """Two fold-epochs of two steps, mixup and cutmix on (the config's),
    bf16, EMA on."""
    out = tmp_path_factory.mktemp("uninterrupted")
    state = train_task.train(_cfg(repo_root, out, *RESUME), device="cpu")
    return state, out


def test_preempt_resume_matches_uninterrupted(repo_root, tmp_path,
                                              uninterrupted):
    """Preempted after 1 of 4 steps, resumed to the end: the weights, the
    EMA copy and the optimizer's moments equal the uninterrupted run's,
    atol 0 (the mixup draws follow the step count)."""
    ref, _ = uninterrupted
    with pytest.raises(SystemExit) as e:
        train_task.train(_cfg(repo_root, tmp_path, *RESUME,
                              "TRAIN.PREEMPT_AFTER_ITERS", "1"),
                         device="cpu")
    assert e.value.code == 0
    cfg = _cfg(repo_root, tmp_path, *RESUME)
    assert cu.get_last_checkpoint(cfg).endswith(
        "checkpoint_epoch_00000_iter_0000001.pyth")
    resumed = train_task.train(cfg, device="cpu")
    assert resumed.step == ref.step == 4
    _assert_equal(_weights(resumed), _weights(ref))
    _assert_equal(resumed.ema, ref.ema)
    got = resumed.optimizer.state_dict()["state"]
    want = ref.optimizer.state_dict()["state"]
    for i in want:
        _assert_equal(got[i], want[i])


def test_auto_resume(repo_root, uninterrupted):
    """The uninterrupted run's last checkpoint resumes at its end."""
    _, out = uninterrupted
    cfg = _cfg(repo_root, out, *RESUME)
    state, start_epoch, start_iter = cu.load_train_checkpoint(cfg,
                                                              _state(cfg))
    assert (start_epoch, start_iter, state.step) == (2, 0, 4)
    assert _names(cfg) == ["checkpoint_epoch_00001.pyth",
                           "checkpoint_epoch_00002.pyth"]


def test_checkpoint_resume_stays_on_fold_grid(repo_root, tmp_path):
    """With NUM_FOLDS 2 a checkpoint after fold-epoch 0 (data epochs 0 and
    1) resumes at epoch 2, not 1."""
    cfg = _cfg(repo_root, tmp_path, "TRAIN.NUM_FOLDS", "2",
               "OPTIMIZER.MAX_EPOCH", "10", "TRAIN.AUTO_RESUME", "true")
    cu.save_checkpoint(cfg, _state(cfg, 7), cur_epoch=0)
    restored, start_epoch, _ = cu.load_train_checkpoint(cfg, _state(cfg))
    assert (start_epoch, restored.step) == (2, 7)
    assert (cfg.OPTIMIZER.MAX_EPOCH - start_epoch) % 2 == 0


def test_val_padding_excluded_from_metrics(repo_root, tmp_path):
    """13 val clips at batch 8 pad the second batch with 3 duplicates: the
    val mean equals the mean over the 13 true clips."""
    cfg = _cfg(repo_root, tmp_path, "TRAIN.NUM_SAMPLES_LIMIT", "13",
               "TRAIN.MIXED_PRECISION", "false")
    state = _state(cfg)
    loader = build_loader(cfg, "val", device="cpu")
    text = compute_text_features(state.model, loader.dataset.text_tokens)
    step = make_eval_step(state.model, cfg)
    stats = train_task.eval_epoch(cfg, state, step, loader,
                                  ValMeter(len(loader), cfg), 0, text)
    ds = loader.dataset
    video = torch.from_numpy(np.stack([ds[i]["video"] for i in range(13)]))
    labels = np.asarray([ds[i]["label"] for i in range(13)])
    preds = step({"video": video, "text_features": text})["preds"].numpy()
    top1 = float((preds.argmax(-1) != labels).mean() * 100.0)
    assert len(loader) == 2
    assert stats["top1_err"] == pytest.approx(top1, abs=1e-4)


@pytest.mark.parametrize("saved_with,resumed_with", [("true", "false"),
                                                     ("false", "true")])
def test_ema_toggled_between_save_and_resume(repo_root, tmp_path,
                                             saved_with, resumed_with):
    """EMA switched on since the save: it restarts from the restored
    weights; switched off: the saved copy is dropped."""
    cfg = _cfg(repo_root, tmp_path, "TRAIN.AUTO_RESUME", "true",
               "MODEL.EMA.ENABLE", saved_with)
    saved = _state(cfg, 3)
    with torch.no_grad():
        for p in saved.model.module.parameters():
            p.mul_(0.5)
    cu.save_checkpoint(cfg, saved, cur_epoch=0)
    cfg = _cfg(repo_root, tmp_path, "TRAIN.AUTO_RESUME", "true",
               "MODEL.EMA.ENABLE", resumed_with)
    restored, _, _ = cu.load_train_checkpoint(cfg, _state(cfg))
    assert restored.step == 3
    _assert_equal(_weights(restored), _weights(saved))
    if resumed_with == "true":
        _assert_equal(restored.ema, _weights(saved))
    else:
        assert restored.ema is None


def test_sigterm_preempts_and_the_disposition_is_restored(repo_root,
                                                          tmp_path,
                                                          monkeypatch):
    """A real SIGTERM in the first step ends the run through a mid-epoch
    checkpoint; after ``train``, preempted or not, SIGTERM has the
    disposition it had before."""
    def before(signum, frame):
        raise AssertionError("the train loop's handler was not installed")

    class Kill(train_task.TrainMeter):
        def update_stats(self, *args):
            super().update_stats(*args)
            if self.num_samples == 8:
                os.kill(os.getpid(), signal.SIGTERM)

    plain = train_task.TrainMeter
    prev = signal.signal(signal.SIGTERM, before)
    try:
        monkeypatch.setattr(train_task, "TrainMeter", Kill)
        opts = RESUME + ["TEST.ENABLE", "false"]
        with pytest.raises(SystemExit) as e:
            train_task.train(_cfg(repo_root, tmp_path, *opts), device="cpu")
        assert e.value.code == 0
        assert signal.getsignal(signal.SIGTERM) is before
        # the step in flight was drained: the kill came in step 1's
        # readback, after step 2 had been queued
        assert cu.get_last_checkpoint(
            _cfg(repo_root, tmp_path, *opts)).endswith(
                "checkpoint_epoch_00001.pyth")
        monkeypatch.setattr(train_task, "TrainMeter", plain)
        train_task.train(_cfg(repo_root, tmp_path, *opts), device="cpu")
        assert signal.getsignal(signal.SIGTERM) is before
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_orbax_output_dir_is_refused(repo_root, tmp_path):
    """An OUTPUT_DIR that holds only the JAX package's Orbax checkpoints
    is an error that says how to convert them, never a fresh start."""
    (tmp_path / "checkpoints" / "checkpoint_epoch_00004").mkdir(parents=True)
    cfg = _cfg(repo_root, tmp_path, "TRAIN.AUTO_RESUME", "true")
    with pytest.raises(NotImplementedError, match="state_dict_from_jax"):
        train_task.train(cfg, device="cpu")
    # beside a port checkpoint, the Orbax directory is passed over
    cu.save_checkpoint(cfg, _state(cfg, 2), cur_epoch=0)
    assert cu.get_last_checkpoint(cfg).endswith("checkpoint_epoch_00001.pyth")


def test_train_needs_a_card_and_one_process(repo_root, tmp_path,
                                            monkeypatch):
    """Without a card, ``train`` needs ``device="cpu"``. A run of more
    than one process is data parallel now (``test_torch_port_ddp.py``);
    what stays refused is a process count other than the config's
    explicit ``TPU.MESH.DATA``, as the JAX package's ``build_mesh``
    refuses a data axis that does not tile the devices."""
    cfg = _cfg(repo_root, tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_task.train(cfg)
    cfg = _cfg(repo_root, tmp_path, "TPU.MESH.DATA", "2")
    with pytest.raises(ValueError, match="TPU.MESH data=2"):
        train_task.train(cfg, device="cpu")
