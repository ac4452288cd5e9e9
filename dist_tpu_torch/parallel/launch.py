"""Start the ranks of a data-parallel run (port of the reference's
``utils/launcher.py::launch_task``, which the JAX package collapsed into
its mesh).

Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) this process joins
the group and runs the task. Otherwise, when the data axis resolves to
N > 1 (``parallel/mesh.py::requested_world``), it starts N processes
with the ``spawn`` start method (CUDA may be initialised here already),
rank r bound to ``cuda:r``, or to the given device, and waits for them:
a rank that fails or dies fails the launch, and the others are stopped.
At N = 1 the task runs in this process, outside any group.

The ranks meet through ``--init_method`` when given, else ``MASTER_ADDR``
and ``MASTER_PORT`` when ``MASTER_PORT`` is set, else a ``file://`` store
in a fresh temporary directory: no free port is probed for.
"""

import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from dist_tpu_torch.parallel import mesh


def launch_task(cfg, func, args=(), device=None, init_method=None,
                timeout=None):
    """Run ``func(*args)`` in every rank of the run ``cfg`` asks for and
    return each rank's result in rank order (in this process: a list of
    one). A rank's ``SystemExit`` (a preemption's) ends the launch with
    the same ``SystemExit`` once every rank has ended. ``timeout``: the
    seconds the spawned ranks may take, none by default."""
    if dist.is_available() and dist.is_initialized():
        return [func(*args)]          # already a rank of a group
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        mesh.init_distributed(cfg, device, init_method=init_method)
        try:
            return [func(*args)]
        finally:
            dist.destroy_process_group()
    world = mesh.requested_world(cfg, device)
    if world == 1:
        return [func(*args)]
    return _spawn(cfg, world, func, args, device, init_method, timeout)


def _spawn(cfg, world, func, args, device, init_method, timeout):
    """Run ``func(*args)`` in ``world`` new processes joined in one group
    (``mesh.init_distributed``); returns their results in rank order (each
    must pickle). Raises if a rank raises, dies without a result, exits
    non-zero or outlives ``timeout`` seconds; the other ranks are stopped
    then. Every rank that ends by ``SystemExit`` makes this raise the
    same ``SystemExit``."""
    tmp = None
    if init_method is None:
        if "MASTER_PORT" in os.environ:
            init_method = "tcp://{}:{}".format(
                os.environ.get("MASTER_ADDR", "localhost"),
                os.environ["MASTER_PORT"])
        else:
            tmp = tempfile.mkdtemp(prefix="dist_tpu_torch_store_")
            init_method = "file://" + os.path.join(tmp, "store")
    # CPU ranks share this process's threads
    threads = (max(1, torch.get_num_threads() // world)
               if device is not None and torch.device(device).type == "cpu"
               else None)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        cfg, rank, world, device, init_method, threads, func, args, results),
        name=f"rank{rank}") for rank in range(world)]
    outcomes = {}
    try:
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        while len(outcomes) < world:
            try:
                rank, kind, value = results.get(timeout=0.5)
            except queue.Empty:
                _check_alive(procs, outcomes, results, deadline)
                continue
            outcomes[rank] = (kind, value)
            if kind == "error":
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
        for p in procs:
            p.join(None if deadline is None
                   else max(deadline - time.monotonic(), 1.0))
        kinds = {k for k, _ in outcomes.values()}
        if "exit" in kinds:
            exits = {v for _, v in outcomes.values()}
            if kinds != {"exit"} or len(exits) != 1:
                raise RuntimeError(f"the ranks ended apart: {outcomes}")
            raise SystemExit(exits.pop())
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"rank exit codes {codes}")
        return [outcomes[r][1] for r in range(world)]
    finally:
        for p in procs:
            if p.pid is None:         # never started
                continue
            if p.is_alive():
                p.kill()
            p.join(10)
        results.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _check_alive(procs, outcomes, results, deadline):
    """Raise if a rank with no result has ended, or past ``deadline``."""
    dead = [r for r, p in enumerate(procs)
            if p.exitcode is not None and r not in outcomes]
    if dead:
        try:    # its result may still be on the way
            rank, kind, value = results.get(timeout=2.0)
            outcomes[rank] = (kind, value)
            if kind == "error":
                raise RuntimeError(f"rank {rank} of {len(procs)} failed:\n"
                                   f"{value}")
            return
        except queue.Empty:
            pass
        raise RuntimeError(
            f"rank(s) {dead} ended with exit codes "
            f"{[procs[r].exitcode for r in dead]} and no result")
    if deadline is not None and time.monotonic() > deadline:
        left = sorted(set(range(len(procs))) - set(outcomes))
        raise TimeoutError(f"ranks {left} still running at the launch's "
                           "time limit")


def _rank_main(cfg, rank, world, device, init_method, threads, func, args,
               results):
    """A spawned rank: join the group, run the task, report its outcome."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        mesh.init_distributed(cfg, device, rank, world, init_method)
        results.put((rank, "ok", func(*args)))
    except SystemExit as e:
        results.put((rank, "exit", e.code))
        raise
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
