"""Finding what a run needs by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``), its limits (``limits/<cell>.json``), the
per-layer metrics' readers (``metrics/<metric>.py``) and the operations'
counts (``ops/<op>.py``). A new cell, mix, metric or operation is a new
file and an entry, and no edit of a file that is there."""

import glob
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return _json(os.path.join(root, "BENCHMARK.json"))


def _dir(root):
    return os.path.join(root, "benchmark")


def cell(name, root=ROOT):
    """(the cell's entry, its configuration, its traffic, its limits)."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; "
                         f"there are {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _json(os.path.join(_dir(root), "traffic", f"{w['traffic']}.json"))
    limits = _json(os.path.join(_dir(root), "limits", f"{name}.json"))
    return w, config, traffic, limits


def metrics_for(cell_name, reported, root=ROOT):
    """The per-layer metrics that ``cell_name`` reports: those that list
    it, and those without a list whose ``moves`` it reports."""
    out = []
    for m in benchmark(root)["per_layer"]:
        cells = m.get("workloads")
        if (cell_name in cells) if cells is not None else (m["moves"] in reported):
            out.append(m)
    return out


def end_to_end_for(cell_name, root=ROOT):
    return [m for m in benchmark(root)["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric_name, root=ROOT):
    """The module of ``metrics/<name>.py``; its ``read(run)`` gives the
    number or None."""
    return _module(os.path.join(_dir(root), "metrics", f"{metric_name}.py"),
                   f"benchmark_metric_{metric_name.replace('.', '_')}")


def operation(op_name, root=ROOT):
    """The module of ``ops/<name>.py``: ``RANGES``, ``calls(run)`` and
    ``work(shape)``."""
    return _module(os.path.join(_dir(root), "ops", f"{op_name}.py"),
                   f"benchmark_op_{op_name}")


def all_ranges(root=ROOT):
    """Every range that an operation of ``ops/`` reads its time under."""
    out = set()
    for path in sorted(glob.glob(os.path.join(_dir(root), "ops", "*.py"))):
        name = os.path.basename(path)[:-3]
        if name != "__init__":
            out.update(operation(name, root).RANGES)
    return sorted(out)
