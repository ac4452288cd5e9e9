"""The reference against the program at the tiny size on the CPU, through
the harness's own path: a train cell's first steps of each configuration
(losses, first gradients, the weights' change) and a serving cell's
answers, in fp32 with the tiny limits. On a card, the same tiny cells
through the program's CUDA kernels."""

import pytest
import torch

from benchmark import run as bench_run
from benchmark.tests import tiny


@pytest.mark.parametrize("cell", ["dist_b16_ssv2.train",
                                  "clip_ft_b16_ssv2.train",
                                  "dist_b16_ssv2.serve"])
def test_reference_agrees_with_the_program(cell):
    run = tiny.run(cell)
    peak, numbers, failed = bench_run.execute(run)
    out, shown = bench_run.result(run, peak, numbers, failed)
    assert out["correct"], shown
    assert failed == 0
    assert set(shown) == set(tiny.LIMITS[run.kind])


@pytest.mark.parametrize("cell", ["dist_b16_ssv2.train",
                                  "dist_b16_ssv2.serve"])
def test_traced_run_reports_its_metrics(cell):
    run = tiny.run(cell, traced=True, seconds=1.0)
    run.traffic = dict(run.traffic, trace_skip_steps=1, trace_steps=3,
                       trace_after=0.2, trace_batches=4)
    out, _ = bench_run.result(run, *bench_run.execute(run))
    assert out["correct"]
    assert out["device"]["window_s"] > 0
    names = set(out["metrics"])
    if run.kind == "train":
        assert {"train.host_ms_per_step", "train_mfu", "device_idle.train"} <= names
    else:
        assert {"serve.batch_clips", "serve.p50_ms", "serve_mfu",
                "device_idle.serve"} <= names
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["dist_b16_ssv2.train",
                                  "clip_ft_b16_ssv2.train",
                                  "dist_b16_ssv2.serve"])
def test_reference_agrees_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels run there")
    run = tiny.run(cell)
    run.device = torch.device("cuda", 0)
    out, shown = bench_run.result(run, *bench_run.execute(run))
    assert out["correct"], shown
