"""The port's tools (``dist_tpu_torch/tools``) on the CPU at shrunken
sizes, second half: microbench's filters and its failing-variant report,
``profile_eval``, ``bench``, ``bench_serving``, ``serve``, the profiling
helpers, the tools' need of a card and ``train_run_errors``. The first
half, ``test_torch_port_tools.py``, runs every microbench command and
pins the kernel-source variants; the two are apart so that the suite's
workers share them."""

import json
import os

import pytest
import torch

from dist_tpu_torch.tools import (
    bench,
    bench_serving,
    microbench,
    profile_eval,
    serve,
    train_run_errors,
)
from tests.test_torch_port_tools import (  # noqa: F401  (a fixture)
    TINY,
    VARIANTS,
    _lines,
    tiny_microbench,
)


def test_microbench_names_filter_and_parity_opt_in(tiny_microbench, capsys):
    assert microbench.main(["dist", "t2i", "--device", "cpu"]) == 0
    assert [r["variant"] for r in _lines(capsys)] == ["t2i"]
    assert microbench.main(["bwd", "dist_fwd_bwd", "parity",
                            "--device", "cpu"]) == 0
    assert [r["variant"] for r in _lines(capsys)] == [
        "dist_fwd_bwd", "fused_vs_unfused_parity"]


def test_microbench_reports_a_failing_variant(tiny_microbench, capsys,
                                              monkeypatch):
    """A variant that raises prints an ``error`` line, the others still
    run, and the tool exits 1."""
    from dist_tpu_torch.ops import attention

    def broken(*args):
        raise RuntimeError("kernel refused")

    monkeypatch.setattr(attention, "attention_qkv_rows", broken)
    assert microbench.main(["attn", "--device", "cpu"]) == 1
    lines = _lines(capsys)
    assert [r["variant"] for r in lines] == VARIANTS["attn"]
    assert [("error" in r) for r in lines] == [False] * 3 + [True] * 3


def test_profile_eval(monkeypatch, capsys):
    for name, value in {"BATCH": 1, "ITERS": 1, "MATMUL_N": 64,
                        "CFG": TINY}.items():
        monkeypatch.setattr(profile_eval, name, value)
    assert profile_eval.main(["--device", "cpu"]) == 0
    lines = _lines(capsys)
    assert [r["component"] for r in lines] == [
        "matmul_peak", "full_eval", "tower_taps", "tower_notaps",
        "dist_net", "attn_kernel_x1", "ln_gelu_x1"]
    with_flops = {"matmul_peak", "full_eval", "tower_taps", "tower_notaps",
                  "attn_kernel_x1"}
    for r in lines:
        assert r["ms"] > 0 and r["first_call_s"] > 0 and r["device"] == "cpu"
        assert ("tflops" in r) == (r["component"] in with_flops)
    assert profile_eval.main(["attn_kernel", "--device", "cpu"]) == 0
    assert [r["component"] for r in _lines(capsys)] == ["attn_kernel_x1"]
    # BENCH_OPTS: the side network with the TemporalNet fused
    monkeypatch.setattr(profile_eval, "OPTS",
                        ["TPU.FUSED_TEMPORAL_NET", "true"])
    assert profile_eval.main(["dist_net", "--device", "cpu"]) == 0
    assert [r["component"] for r in _lines(capsys)] == ["dist_net"]
    with pytest.raises(SystemExit):
        profile_eval.main(["no_such_component", "--device", "cpu"])


def test_bench_prints_both_metrics(monkeypatch, capsys):
    for name, value in {"BATCH": 1, "ITERS": 1, "WARMUP": 0,
                        "CFG": TINY}.items():
        monkeypatch.setattr(bench, name, value)
    monkeypatch.setenv("BENCH_MEMSTATS", "1")   # no card: nothing to add
    assert bench.main(["--device", "cpu"]) == 0
    lines = _lines(capsys)
    assert [r["metric"] for r in lines] == ["clips_per_sec_per_chip",
                                            "train_clips_per_sec_per_chip"]
    for r in lines:
        assert r["unit"] == "clips/s" and r["value"] > 0
        assert r["vs_baseline"] == pytest.approx(
            r["value"] / bench.REFERENCE_CLIPS_PER_SEC)
        assert r["device"] == "cpu" and "bytes_in_use" not in r


def test_bench_serving(capsys):
    assert bench_serving.main([
        "--cfg", TINY, "--batch", "2", "--iters", "2", "--load-seconds",
        "0.2", "--device", "cpu"]) == 0
    (result,) = _lines(capsys)
    assert result["config"] == TINY and result["buckets"] == [1, 2]
    for key in ("engine_batch1", "engine_full_batch", "microbatcher_batch1",
                "device_step_batch1", "device_step_full_batch",
                "h2d_upload_batch1", "h2d_upload_full_batch"):
        assert {"p50_ms", "p99_ms", "mean_ms"} <= set(result[key]), key
    assert result["sustained_load"]["clients"] == 4
    assert result["sustained_load"]["clips_per_sec"] > 0
    assert result["batch1_bucketed_vs_padded_speedup"] > 0
    assert result["h2d_upload_full_batch"]["mb"] == pytest.approx(
        2 * result["h2d_upload_batch1"]["mb"])


def test_serve_builds_the_server_and_shuts_down(repo_root, monkeypatch):
    from dist_tpu_torch.serving import server as server_mod

    built = {}

    def interrupted(self):
        # the HTTP loop runs, then Ctrl-C reaches the foreground
        built["server"] = self.__enter__()
        raise KeyboardInterrupt

    monkeypatch.setattr(server_mod.VideoClassifierServer, "serve_forever",
                        interrupted)
    assert serve.main(["--cfg", os.path.join(repo_root, TINY), "--port", "0",
                       "--host", "127.0.0.1", "--batch", "2",
                       "--device", "cpu"]) == 0
    s = built["server"]
    assert s.engine.batch_size == 2 and s.engine.ready
    assert not s.batcher._thread.is_alive()


def test_profiling_helpers(tmp_path):
    """The counterparts of test_profiling.py's checks, on the CPU."""
    from dist_tpu_torch.utils import profiling

    with profiling.trace(str(tmp_path / "trace")):
        x = torch.ones((8, 8)) @ torch.ones((8, 8))
    assert float(x[0, 0]) == 8.0
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    times = []
    with profiling.step_timer("t", result=times) as box:
        box["output"] = {"a": [torch.ones(4) * 2]}
    assert len(times) == 1 and times[0] >= 0.0
    assert profiling.sync(box["output"]) is box["output"]
    assert profiling.device_memory_stats() == {}     # no card here
    calls = []
    first, ms = profiling.time_calls(lambda: calls.append(1), "cpu", reps=3,
                                     outer=2, warmup=1)
    assert len(calls) == 1 + 1 + 6 and first >= 0.0 and ms >= 0.0


@pytest.mark.parametrize("run", [
    lambda: microbench.main(["attn"]),
    lambda: profile_eval.main(["attn_kernel"]),
    lambda: bench.main([]),
    lambda: bench_serving.main(["--cfg", TINY]),
    lambda: serve.main(["--cfg", TINY, "--port", "0"]),
    lambda: train_run_errors.main(["--cfg", TINY]),
], ids=["microbench", "profile_eval", "bench", "bench_serving", "serve",
        "train_run_errors"])
def test_tools_need_a_card_unless_told(monkeypatch, run):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run()


@pytest.fixture
def few_threads():
    """Two intra-op threads for the port while the test runs: the suite
    runs in several worker processes at once, and every core in each of
    them would oversubscribe the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_train_run_errors_on_the_cpu(capsys, few_threads):
    """The readings tool behind chip_smoke.py's TRAIN_RUN_RESUME_LIMIT, one
    repeat at the tiny size (4 steps a fold-epoch, as on the flagship):
    both runs take 8 steps and, on the CPU, end bit for bit equal."""
    train_run_errors.main(["--device", "cpu", "--repeats", "1", "--cfg", TINY,
                           "TRAIN.BATCH_SIZE", "8", "TRAIN.NUM_FOLDS", "4",
                           "TRAIN.NUM_SAMPLES_LIMIT", "8"])
    # the train loop logs to stdout too
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"device"')]
    assert lines[0]["steps"] == [8, 8] and lines[0]["max_abs_diff"] == 0.0
    assert lines[-1] == {"device": "cpu", "worst_max_abs_diff": 0.0}
