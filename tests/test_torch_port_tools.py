"""The port's tools (``dist_tpu_torch/tools``) on the CPU at shrunken sizes
(the tiny config, one repetition): every printed line parses, carries the
keys of the JAX tool it ports and holds no ``error``; ``bench`` prints both
metrics; without ``--device cpu`` and without a card, every tool raises.
The numbers are CPU times and are not checked."""

import json
import os

import pytest
import torch

from dist_tpu_torch.tools import (
    attn_variants,
    bench,
    bench_serving,
    microbench,
    profile_eval,
    serve,
    tnet_bwd,
)

TINY = "configs/projects/dist/test/tiny_synth.yaml"


def _lines(capsys):
    out = capsys.readouterr().out
    return [json.loads(ln) for ln in out.splitlines() if ln.strip()]


@pytest.fixture
def tiny_microbench(monkeypatch):
    for name, value in {
            "REPS": 1, "OUTER": 1, "BATCH": 1, "CFG": TINY,
            "ATTN": (4, 17, 2, 16), "ATTN_ROWS": (1, 2, 4),
            "GEOMETRY": {"frames": 4, "crop": 32, "patch": 16, "width": 64,
                         "layers": 2, "embed": 32, "alpha": 2},
            "INT8_SHAPES": ((32, 16, 24), (32, 24, 16))}.items():
        monkeypatch.setattr(microbench, name, value)


# the variants each subcommand prints (the JAX tool's, renamed where the
# port's shipped formulation differs)
VARIANTS = {
    "attn": ["attn_shipped", "attn_plain", "attn_sdpa", "attn_rows1",
             "attn_rows2", "attn_rows4"],
    "stem": ["stem_conv3d", "stem_transpose", "stem_rows",
             "tower_conv1_dense", "tower_conv1_sparse"],
    "conv33": ["conv33_fwd_bwd", "mm33_fwd_bwd"],
    "int8": ["bf16_32x16x24", "int8_32x16x24", "bf16_32x24x16",
             "int8_32x24x16"],
    "dist": ["dist_full", "dist_full_fused", "stem", "temporal_net",
             "integration", "input_linear", "t2i", "i2t", "adapool"],
    "bwd": ["dist_fwd_bwd", "dist_fwd_bwd_fused", "dist_fwd_bwd_remat",
            "dist_fwd_bwd_remat_fused", "fused_vs_unfused_parity",
            "stem_fwd_bwd"],
    "bwd_parts": ["stem_fwd_bwd", "temporal_net_fwd_bwd",
                  "integration_fwd_bwd", "input_linear_fwd_bwd",
                  "t2i_fwd_bwd", "i2t_fwd_bwd", "adapool_fwd_bwd"],
    "train": ["train_step_full", "loss_fwd_only", "loss_fwd_bwd",
              "optimizer_only"],
}
# the variants that report a max |difference| against the shipped one
WITH_DIFF = {"attn_plain", "attn_rows1", "attn_rows2", "attn_rows4",
             "stem_transpose", "stem_rows", "fused_vs_unfused_parity"}


@pytest.mark.parametrize("command", sorted(VARIANTS))
def test_microbench_command(tiny_microbench, capsys, command):
    assert microbench.main([command, "--device", "cpu"]) == 0
    lines = _lines(capsys)
    assert all("error" not in r for r in lines), lines
    if command == "conv33":
        check, lines = lines[0], lines[1:]
        assert check["check"] == "max_abs_diff" and check["v"] >= 0
    assert [r["variant"] for r in lines] == VARIANTS[command]
    for r in lines:
        if "not_ported" in r:
            assert "remat" in r["variant"]
        elif r["variant"] == "fused_vs_unfused_parity":
            assert r["max_abs_diff"] <= r["out_max"]
        else:
            assert r["ms"] > 0 and r["first_call_s"] > 0
            assert r["device"] == "cpu"
        assert ("max_abs_diff" in r) == (r["variant"] in WITH_DIFF)


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
], ids=["microbench", "profile_eval", "bench", "bench_serving", "serve"])
def test_tools_need_a_card_unless_told(monkeypatch, run):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run()


@pytest.mark.parametrize("name", sorted(attn_variants.VARIANTS))
def test_attn_variants_apply_to_the_kernel_source(name):
    """Each variant's substitutions find their anchors in
    ``csrc/attention.cu`` as often as stated, so an edit of the kernel that
    moves one fails here and not on the card."""
    src = attn_variants.variant_source(name)
    with open(os.path.join(attn_variants._build.SRC_DIR, "attention.cu")) as f:
        shipped = f.read()
    assert (src == shipped) == (name == "shipped")
    assert src.count("#if 0") == {"copies_only": 2, "math_only": 1}.get(name, 0)


def test_attn_variants_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs the CUDA card"):
        attn_variants.main([])


@pytest.mark.parametrize("name", sorted(tnet_bwd.VARIANTS))
def test_tnet_bwd_variants_apply_to_the_kernel_source(name):
    """Each K3 variant's substitutions find their anchors in
    ``csrc/temporal_net.cu`` once, and only the bf16 route's lines move."""
    src = attn_variants.variant_source(name, "temporal_net",
                                       tnet_bwd.VARIANTS)
    with open(os.path.join(attn_variants._build.SRC_DIR,
                           "temporal_net.cu")) as f:
        shipped = f.read()
    assert (src == shipped) == (name == "shipped")
    moved = [a for a, b in zip(shipped.splitlines(), src.splitlines())
             if a != b]
    assert len(moved) == len(tnet_bwd.VARIANTS[name])
    assert all("rows_times_weights" in ln or "a_t_b" in ln
               or "cp_async16" in ln for ln in moved)


@pytest.mark.parametrize("mangled,name", [
    ("_ZN12_GLOBAL__N_12k315k3_stage_kernelILi96ELi1EEEvNS0_4ArgsE",
     "k3_stage_kernel<96, B>"),
    ("_ZN12_GLOBAL__N_12k315k3_wgrad_kernelILi128EEEvNS0_4ArgsEi",
     "k3_wgrad_kernel<128>"),
    ("_ZN12_GLOBAL__N_12k313k3_sum_kernelEPKfiNS0_8SegmentsE",
     "k3_sum_kernel"),
    ("_ZN12_GLOBAL__N_114sum_rows_kernelEPKfPfii",
     "_ZN12_GLOBAL__N_114sum_rows_kernelEPKfPfii")])
def test_tnet_bwd_instance_names(mangled, name):
    assert tnet_bwd.instance_name(mangled) == name


@pytest.mark.parametrize("cmd", ["errors", "variants"])
def test_tnet_bwd_needs_a_card(monkeypatch, cmd):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs the CUDA card"):
        tnet_bwd.main([cmd])


def test_tnet_bwd_readings_and_control_on_cpu():
    """The readings on the CPU, where the wrapper runs the plain version:
    the kernel's readings are zero and the control's are not, so the
    control breaks any limits."""
    from dist_tpu_torch.ops import temporal_net as tn

    x, g, params = _cpu_inputs()

    got = tn.fused_temporal_net_bwd(x, g, *params)
    assert all(v == {"max_rel": 0.0, "rel_l2": 0.0}
               for v in tnet_bwd.errors(got, tn.temporal_net_bwd_plain(
                   x, g, *params)).values())
    control = tnet_bwd.errors(got, tn.temporal_net_bwd_plain(
        x, g, *tnet_bwd.control_params(params)))
    limits = {n: {"max_rel": 0.0, "rel_l2": 0.0} for n in tnet_bwd.NAMES}
    assert len(tnet_bwd.breaches(control, limits)) >= 12
    assert params[4][0, 0, 0].abs().sum() > 0     # the original unchanged


def _cpu_inputs():
    gen = torch.Generator().manual_seed(0)
    shape, f, k = (1, 4, 5, 6, 16), 8, 3

    def rnd(*s, scale=1.0):
        return torch.randn(s, generator=gen) * scale

    c = shape[-1]
    return (rnd(*shape), rnd(*shape),
            (1.0 + rnd(c, scale=0.1), rnd(c, scale=0.1),
             rnd(k, 1, 1, c, f, scale=(k * c) ** -0.5), rnd(f, scale=0.1),
             rnd(1, 3, 3, f, c, scale=(9 * f) ** -0.5), rnd(c, scale=0.1)))

