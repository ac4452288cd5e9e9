"""The readings that the limits of ``correct`` are set from, on a CUDA card
at the cell's own size (not run by the benchmark's runs).

    python3 -m benchmark.calibrate --workload <name> --seeds a,b,... \
        --control-seeds c,d,e [--seconds s]

- For each of ``--seeds``, the program as a run drives it: a train cell's
  first steps (no window), a serving cell's window of ``--seconds``; its
  numbers against the reference.
- For each of ``--control-seeds``, the control: the reference computed in
  float8 (e4m3) in the program's place, against the reference; and for a
  train cell the fault "half of the batch left out, the mean taken over
  the rest", planted in the reference. A step that returns its state
  unchanged reads 1 in ``change_gap`` by the measure's definition and
  needs no run.

One JSON line per reading."""

import argparse
import gc
import json
import sys

import torch

from benchmark import checks, harness, serve_cell, spec, train_cell, weights


def _run(cell, config, traffic, limits, seed, seconds):
    return harness.Run(cell=cell, config=config, traffic=traffic,
                       limits=limits, seed=seed, seconds=seconds,
                       traced=False, device=torch.device("cuda", 0),
                       t_start=harness.now())


def _emit(**kw):
    print(json.dumps(kw), flush=True)


def program(run):
    if run.kind == "train":
        _, numbers = train_cell.run_train(run)
        return numbers
    _, numbers, missing = serve_cell.run_serve(run)
    return dict(numbers, missing=missing)


def control(run):
    """{reading: numbers} of the control and the planted faults."""
    if run.kind == "train":
        pool = train_cell._pool(run, run.device)
        ref = train_cell.reference_steps(run, pool)
        out = {}
        for name, kw in (("float8", {"precision": "float8"}),
                         ("half_batch", {"fault": "half_batch"})):
            other = checks.as_program(train_cell.reference_steps(run, pool, **kw))
            worst = {}
            out[name] = dict(checks.train_numbers(other, ref, worst),
                             worst=worst)
        return out
    spec_ = run.spec
    pool = weights.make_clips(run.traffic["pool_clips"], spec_["num_frames"],
                              spec_["crop"], run.seed + 1,
                              run.device).cpu().numpy()
    ids = list(range(run.traffic["pool_clips"]))
    ref = serve_cell.reference_scores(run, pool, ids)
    low = serve_cell.reference_scores(run, pool, ids, precision="float8")
    return {"float8": {"score_gap": checks.score_gap(low, ref)}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    cell, config, traffic, limits = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("calibration runs on the card", file=sys.stderr)
        return 2
    for s in filter(None, args.seeds.split(",")):
        run = _run(cell, config, traffic, limits, int(s), args.seconds)
        _emit(workload=args.workload, seed=int(s), reading="program",
              numbers=program(run))
        gc.collect()
        torch.cuda.empty_cache()
    for s in filter(None, args.control_seeds.split(",")):
        run = _run(cell, config, traffic, limits, int(s), 0.0)
        for name, numbers in control(run).items():
            _emit(workload=args.workload, seed=int(s), reading=name,
                  numbers=numbers)
        gc.collect()
        torch.cuda.empty_cache()
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded modules the benchmark may not load: {bad}",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
