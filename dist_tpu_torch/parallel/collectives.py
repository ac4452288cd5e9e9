"""Host-side exchanges across ranks (port of
``dist_tpu/parallel/collectives.py``).

The train step's gradient mean is DDP's (``parallel/mesh.py::wrap_ddp``);
what remains is the host side: gathering the ranks' numpy results, the
mean of their scalars, the agreed flags and a barrier. Each is the
identity in a process outside any group. Under NCCL the exchanged values
ride this rank's card, under gloo the CPU. ``local_rows`` has no
counterpart: each rank holds exactly its own rows.
"""

import numpy as np
import torch
import torch.distributed as dist


def _in_group():
    return dist.is_available() and dist.is_initialized()


def is_master_proc():
    """(reference utils/distributed.py:98-105)"""
    return get_rank() == 0


def get_world_size():
    return dist.get_world_size() if _in_group() else 1


def get_rank():
    return dist.get_rank() if _in_group() else 0


def _device():
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_arrays(*arrays):
    """Gather each rank's numpy arrays to every rank, concatenated in rank
    order along the leading axis (reference ``du.all_gather``,
    utils/distributed.py:19-38). The ranks' lengths may differ.
    Outside a group: identity."""
    if get_world_size() == 1:
        return list(arrays)
    gathered = [None] * get_world_size()
    dist.all_gather_object(gathered, [np.asarray(a) for a in arrays])
    return [np.concatenate([g[i] for g in gathered], axis=0)
            for i in range(len(arrays))]


def all_reduce_mean(*scalars):
    """Mean of host scalars across ranks, in float64 (reference
    ``du.all_reduce`` with average, utils/distributed.py:41-57)."""
    if get_world_size() == 1:
        return [float(s) for s in scalars]
    t = torch.tensor([float(s) for s in scalars], dtype=torch.float64,
                     device=_device())
    dist.all_reduce(t)
    return (t / get_world_size()).tolist()


def any_flag(flag):
    """Cross-rank OR of a per-rank boolean (every rank must call in). Used
    to agree on a host-side event before acting on it together, e.g. the
    preemption stop: ranks receive SIGTERM at different times, and acting
    on the local flag alone would have them leave the step loop at
    different iterations (mismatched collectives, divergent checkpoint
    names)."""
    if get_world_size() == 1:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def broadcast_from_master(value):
    """Rank 0's ``value`` (any picklable object) on every rank."""
    if get_world_size() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def synchronize():
    """Barrier across ranks (reference utils/distributed.py:130-142)."""
    if get_world_size() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
