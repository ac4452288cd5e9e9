"""The benchmark stands apart: it loads neither JAX nor the JAX package,
reads none of the JAX package's benchmark files, writes only under the
checkout and the run's HOME, XDG_CACHE_HOME and TMPDIR, and picks up a
configuration, a traffic mix and a per-layer metric added as new files."""

import ast
import builtins
import glob
import io
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run as bench_run
from benchmark import spec
from benchmark.harness import FORBIDDEN
from benchmark.tests import tiny

BENCH = os.path.join(spec.ROOT, "benchmark")


def _sources():
    return sorted(glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True))


def _imported_top_levels(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, BENCH))
def test_sources_import_no_jax(path):
    assert not _imported_top_levels(path) & set(FORBIDDEN)


def test_names_compare_whole():
    """``dist_tpu_torch`` is the program and allowed; ``dist_tpu`` is not."""
    names = _imported_top_levels(os.path.join(BENCH, "train_cell.py"))
    assert "dist_tpu_torch" not in FORBIDDEN and "dist_tpu" in FORBIDDEN
    assert "dist_tpu_torch" not in names & set(FORBIDDEN)


def test_a_run_loads_no_jax():
    """A whole tiny run in a fresh process leaves no forbidden module in
    ``sys.modules``."""
    code = (
        "import sys; from benchmark.tests import tiny; "
        "from benchmark import run as r, harness; "
        "x = tiny.run('dist_b16_ssv2.train', seconds=0.2); r.execute(x); "
        "y = tiny.run('dist_b16_ssv2.serve', seconds=0.2); r.execute(y); "
        "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reads_no_jax_benchmark_file():
    for path in _sources():
        text = open(path).read()
        for name in ("bench.py", "BENCH_r", "BASELINE.json", "MULTICHIP_r"):
            assert name not in text or path.endswith("test_bench_isolation.py"), \
                (path, name)


def test_writes_stay_inside(tmp_path, monkeypatch):
    """Every file a tiny traced run opens for writing lies under the
    checkout, HOME, XDG_CACHE_HOME or TMPDIR."""
    for var in ("HOME", "XDG_CACHE_HOME", "TMPDIR"):
        d = tmp_path / var.lower()
        d.mkdir()
        monkeypatch.setenv(var, str(d))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    allowed = [os.path.realpath(p) for p in
               (spec.ROOT, os.environ["HOME"], os.environ["XDG_CACHE_HOME"],
                os.environ["TMPDIR"])]
    written = []
    real_open, real_os_open = builtins.open, os.open

    def note(path):
        written.append(os.path.realpath(os.fspath(path)))

    def fake_open(file, mode="r", *a, **k):
        if isinstance(file, (str, bytes, os.PathLike)) and any(
                c in mode for c in "wax+"):
            note(file)
        return real_open(file, mode, *a, **k)

    def fake_os_open(path, flags, *a, **k):
        if flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT):
            note(path)
        return real_os_open(path, flags, *a, **k)

    monkeypatch.setattr(builtins, "open", fake_open)
    monkeypatch.setattr(io, "open", fake_open)
    monkeypatch.setattr(os, "open", fake_os_open)
    for cell in ("dist_b16_ssv2.train", "dist_b16_ssv2.serve"):
        run = tiny.run(cell, traced=True, seconds=0.6)
        run.traffic = dict(run.traffic, trace_skip_steps=1, trace_steps=2,
                           trace_after=0.1, trace_batches=2)
        bench_run.result(run, *bench_run.execute(run))
    assert written, "the traced runs write their trace under TMPDIR"
    for path in written:
        assert any(path == a or path.startswith(a + os.sep) for a in allowed), path


def test_new_files_are_picked_up(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files (and entries in BENCHMARK.json) in a copy of the benchmark run
    without an edit of any file that was there."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
    before = {p: open(p, "rb").read() for p in
              glob.glob(str(root / "benchmark" / "**" / "*"), recursive=True)
              if os.path.isfile(p)}
    cfg = tiny.config("dist_b16_ssv2")
    (root / "benchmark" / "configs" / "tiny_dist.json").write_text(json.dumps(cfg))
    traffic = json.load(open(os.path.join(BENCH, "traffic", "train.json")))
    traffic.update(pool_batches=4, check_steps=3, warm_steps=1,
                   trace_skip_steps=1, trace_steps=2)
    (root / "benchmark" / "traffic" / "train_short.json").write_text(
        json.dumps(traffic))
    (root / "benchmark" / "limits" / "tiny_dist.train_short.json").write_text(
        json.dumps(tiny.LIMITS["train"]))
    (root / "benchmark" / "metrics" / "train.steps_traced.py").write_text(
        '"""Steps in the traced stretch."""\n\n\n'
        "def read(run):\n"
        "    return float(len(run.trace.batches)) if run.trace else None\n")
    bench["configs"].append({"name": "tiny_dist", "source": "tiny",
                             "file": "benchmark/configs/tiny_dist.json",
                             "reduced": [], "why": "tiny"})
    bench["workloads"].append({"name": "tiny_dist.train_short",
                               "config": "tiny_dist", "traffic": "train_short",
                               "chips": 1, "why": "tiny"})
    bench["per_layer"].append({"name": "train.steps_traced", "unit": "steps",
                               "better": "higher", "source": "device_trace",
                               "layer": "train step",
                               "moves": "train_clips_per_s",
                               "workloads": ["tiny_dist.train_short"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"].startswith("train_"):
            m["workloads"].append("tiny_dist.train_short")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell, config, traffic, limits = spec.cell("tiny_dist.train_short", str(root))
    run = tiny.run("dist_b16_ssv2.train", traced=True, seconds=0.6)
    run.cell, run.config, run.traffic, run.limits = cell, config, traffic, limits
    run.root = str(root)
    out, _ = bench_run.result(run, *bench_run.execute(run))
    assert out["correct"]
    assert out["metrics"]["train.steps_traced"]["value"] == 2.0
    for p, data in before.items():
        assert open(p, "rb").read() == data, p
