"""The comparison fails what it has to: the control (the reference in
float8 in the program's place) reads over the limits, and a run of the
harness with the timed path broken underneath comes out not correct, for
each fault its cells can have: a step that returns its state unchanged,
half of the batch left out with the mean over the rest, an answer altered
where it is produced. (No cell spans chips, so there is no exchange to
leave out.)"""

import numpy as np
import pytest
import torch

from benchmark import calibrate, checks, run as bench_run
from benchmark.tests import tiny


@pytest.mark.parametrize("cell", ["dist_b16_ssv2.train",
                                  "clip_ft_b16_ssv2.train",
                                  "dist_b16_ssv2.serve"])
def test_control_fails(cell):
    run = tiny.run(cell)
    readings = calibrate.control(run)
    ok, shown = checks.judge(readings["float8"], tiny.LIMITS[run.kind])
    assert not ok, shown
    if run.kind == "train":
        ok, shown = checks.judge(readings["half_batch"], tiny.LIMITS["train"])
        assert not ok, shown


def _correct(run):
    out, shown = bench_run.result(run, *bench_run.execute(run))
    return out["correct"], shown


@pytest.mark.parametrize("cell", ["dist_b16_ssv2.train",
                                  "clip_ft_b16_ssv2.train"])
def test_unchanged_state_is_not_correct(cell, monkeypatch):
    from dist_tpu_torch.tasks import state as st

    real = st.make_train_step

    def make(model, cfg, optimizer, lr_fn):
        step = real(model, cfg, optimizer, lr_fn)

        def frozen(state, batch):
            before = {k: v.detach().clone()
                      for k, v in model.module.state_dict().items()}
            metrics = step(state, batch)
            model.module.load_state_dict(before)
            return metrics
        return frozen

    monkeypatch.setattr(st, "make_train_step", make)
    ok, shown = _correct(tiny.run(cell))
    assert not ok
    assert shown["change_gap"]["value"] > shown["change_gap"]["limit"]


@pytest.mark.parametrize("cell", ["dist_b16_ssv2.train",
                                  "clip_ft_b16_ssv2.train"])
def test_half_batch_is_not_correct(cell, monkeypatch):
    from dist_tpu_torch.tasks import state as st

    real = st.make_train_step

    def make(model, cfg, optimizer, lr_fn):
        step = real(model, cfg, optimizer, lr_fn)

        def half(state, batch):
            n = batch["video"].shape[0] // 2
            return step(state, {k: (v[:n] if k in ("video", "labels") else v)
                                for k, v in batch.items()})
        return half

    monkeypatch.setattr(st, "make_train_step", make)
    ok, shown = _correct(tiny.run(cell))
    assert not ok, shown


def test_altered_answer_is_not_correct(monkeypatch):
    from dist_tpu_torch.serving import engine as eng

    real = eng.InferenceEngine.predict

    def altered(self, clips):
        out = np.array(real(self, clips))
        out[0] = out[0][::-1]
        return out

    monkeypatch.setattr(eng.InferenceEngine, "predict", altered)
    run = tiny.run("dist_b16_ssv2.serve")
    ok, shown = _correct(run)
    assert not ok, shown
