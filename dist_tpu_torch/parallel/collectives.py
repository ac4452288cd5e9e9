"""Host-side exchanges across ranks (port of
``dist_tpu/parallel/collectives.py``).

The train step's gradient mean is DDP's (``parallel/mesh.py::wrap_ddp``);
what remains is the host side: gathering the ranks' numpy results, the
mean of their scalars, the agreed flags and a barrier; and, inside the
step, :func:`gather_with_grad`, the rows of every rank for a loss that
mixes samples (the SSL losses). Each is the identity in a process outside
any group. Under NCCL the exchanged values
ride this rank's card, under gloo the CPU. ``local_rows`` has no
counterpart: each rank holds exactly its own rows.

Results and metrics are exchanged over the data axis
(``parallel/mesh.py::Layout``): the ranks of one data shard (its model
or pipe ranks) hold the same rows and the same values, so a gather over
every rank would count them more than once. :func:`data_rank` and
:func:`data_size` name this rank's shard and the shards' count.
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


def _layout():
    from dist_tpu_torch.parallel.mesh import layout
    return layout()


def data_rank():
    """This rank's data shard (0 outside a group)."""
    return _layout().data_rank


def data_size():
    """The data axis: the count of data shards (1 outside a group)."""
    return _layout().data


def _device():
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _GatherSplice(torch.autograd.Function):
    """Forward: every rank's rows, in rank order. Backward: this rank's
    slice of the gradient times the world size."""

    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        lay = _layout()
        parts = [torch.empty_like(x) for _ in range(lay.data)]
        dist.all_gather(parts, x, group=lay.data_group)
        # this rank's own rows, so that the rows are x itself
        parts[lay.data_rank] = x
        ctx.rows, ctx.rank, ctx.world = x.shape[0], lay.data_rank, lay.data
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.rows
        return grad[lo:lo + ctx.rows] * ctx.world


def gather_with_grad(x):
    """Every rank's rows of ``x`` (the same count on each), concatenated
    in rank order, with a gradient to this rank's own rows (the
    reference's ``construct_logits_with_gradient``).

    Every rank then computes the loss of the global batch, as the JAX
    step does in one program. Each rank's gradient reaches only its own
    rows, so the backward multiplies it by the world size: DDP's mean over
    the ranks then gives the global loss's gradient, both to the weights
    before the gather (each rank holds its rows' part) and to those after
    it (each rank holds the whole). Outside a group: ``x``."""
    if data_size() == 1:
        return x
    return _GatherSplice.apply(x)


def all_gather_arrays(*arrays):
    """Gather each data shard's numpy arrays to every rank, concatenated
    in data-shard order along the leading axis (reference
    ``du.all_gather``, utils/distributed.py:19-38). The shards' lengths
    may differ. With one data shard (and outside a group): identity."""
    lay = _layout()
    if lay.data == 1:
        return list(arrays)
    gathered = [None] * lay.data
    dist.all_gather_object(gathered, [np.asarray(a) for a in arrays],
                           group=lay.data_group)
    return [np.concatenate([g[i] for g in gathered], axis=0)
            for i in range(len(arrays))]


def all_reduce_mean(*scalars):
    """Mean of host scalars across the data shards, in float64 (reference
    ``du.all_reduce`` with average, utils/distributed.py:41-57)."""
    lay = _layout()
    if lay.data == 1:
        return [float(s) for s in scalars]
    t = torch.tensor([float(s) for s in scalars], dtype=torch.float64,
                     device=_device())
    dist.all_reduce(t, group=lay.data_group)
    return (t / lay.data).tolist()


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
