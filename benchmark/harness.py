"""What the kinds of cell share: a run's context, the process's start,
the program's configuration from a cell's configuration file, and the
result line."""

import dataclasses
import gc
import json
import os
import sys
import time
from typing import Any, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dist_tpu")
CFG_SEED_MOD = 2 ** 31


def process_age_s():
    """Seconds since this process started, from the kernel's record of
    its start (``/proc/self/stat``), so that the interpreter's own start
    counts; None where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


@dataclasses.dataclass
class Run:
    """One run of one cell, and what its readers read."""

    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    traced: bool
    device: Any
    t_start: float                 # perf_counter at the process's start
    chips: int = 1
    root: str = ""                 # the checkout; the files are found there
    kind: str = ""
    trace: Optional[Any] = None    # trace.Trace of the traced stretch
    window: dict = dataclasses.field(default_factory=dict)
    spans: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        from benchmark import spec

        self.kind = self.traffic["kind"]
        self.root = self.root or spec.ROOT

    @property
    def spec(self):
        return self.config["reference"]

    @property
    def cfg_seed(self):
        """The program's ``RANDOM_SEED`` (its mixing and dropout draws)."""
        return int(self.seed) % CFG_SEED_MOD


def program_config(run, extra=()):
    """The program's configuration: the cell configuration's YAML and
    overrides, the run's seed; checked against the numbers the reference
    is built from (``expect``)."""
    from dist_tpu_torch.config import load_config

    c = run.config
    cfg = load_config(c["yaml"], list(c["opts"]) + ["RANDOM_SEED", str(run.cfg_seed)]
                      + list(extra), make_output_dir=False)
    wrong = {}
    for key, want in c["expect"].items():
        got = cfg
        for part in key.split("."):
            got = getattr(got, part)
        if isinstance(want, list):
            got = list(got)
        if got != want:
            wrong[key] = (got, want)
    if wrong:
        raise SystemExit(f"the program's configuration is not the one the "
                         f"reference computes: {wrong}")
    return cfg


def settle():
    """End of set-up: collect, then move every object set-up made out of
    the collector's view, so that the window's collections scan only what
    the window makes."""
    gc.collect()
    gc.freeze()


def forbidden_modules():
    """Top-level names in ``sys.modules`` that the benchmark may not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def emit(result, checks):
    """The checks as the last lines of standard error, then the result
    line on standard output, the checks last in it."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    result = dict(result)
    result["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def now():
    return time.perf_counter()


_T0 = time.perf_counter()


def note(text):
    """A line on standard error, with the seconds since this module was
    imported."""
    print(f"[{time.perf_counter() - _T0:8.2f} s] {text}", file=sys.stderr,
          flush=True)
