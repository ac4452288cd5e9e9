"""The GPipe ``pipe`` axis for the CLIP tower (port of
``dist_tpu/parallel/pipeline.py``).

The tower's ``L`` resblocks are split into ``S`` contiguous stages over
the ranks of the pipe group: stage ``s`` runs layers ``[s L / S, (s + 1)
L / S)``. The batch is split into ``M`` microbatches; at tick ``t`` stage
``s`` runs its layers on microbatch ``t - s`` and hands the activation to
stage ``s + 1``; ``M + S - 1`` ticks drain the pipe (bubble fraction
``(S - 1) / (M + S - 1)``). As in the JAX package every stage runs its
layers at every tick, the bubble's ticks on whatever it holds, and keeps
only the valid results, so that every rank runs the same collectives in
the same order, forward and backward (every tick's result is tied to the
output with a zero weight, so that every handoff's backward runs on every
rank).

- **The handoff.** The JAX package's ring ``ppermute`` becomes an
  all-gather over the pipe group of which each stage keeps its
  predecessor's activation (:func:`ring_shift`; its backward all-gathers
  the gradients and keeps its successor's). Gloo's point-to-point calls
  may not take CUDA tensors, and its all-gather does, as NCCL's does: one
  transport for the CPU's gloo, gloo ranks sharing a card, and NCCL.
- **Input.** Every rank holds the stack's input and stage 0 reads it:
  its gradient is summed over the stages (``parallel/tensor.py::
  copy_to``), so that the layers before the stack get theirs on every
  rank, as the transpose of the JAX package's replicated input.
- **Outputs.** Each stage fills its own layers' taps; the last stage's
  output and the stages' disjoint tap chunks come back whole on every
  rank through one all-reduce each (:func:`replicate_sum`: identity
  backward, since every rank computes the rest of the model alike).
- **Weights.** Each rank holds only its own stage's blocks, as the JAX
  package's ``shard_params`` shards the stacked tower on its layer axis
  over ``pipe``: :func:`check_model` puts a weightless
  :class:`HeldElsewhere` in the place of every other stage's block, so
  that the optimizer, DDP and the EMA copy see only this stage's. A
  stage's gradients live on its own rank; DDP averages them over the
  data group. The checkpoints still hold every block, gathered from
  each stage's rank (``parallel/shards.py``).

The schedule is differentiable, so it serves training. Only
``ClipVisionTextTransformer`` takes it (``models/base/models.py``), and
not together with the model axis (``parallel/mesh.py``). Under
``TPU.FSDP`` the stage's blocks are one FSDP2 unit sharded over the data
group, gathered once at the stage's entry and kept across the ticks
(``parallel/fsdp.py``); every rank of a data group holds the same stage
and runs the same ticks, so the data group's all-gathers and
reduce-scatters and the pipe group's handoffs come in one order on every
rank.
"""

import torch
import torch.distributed as dist
import torch.nn as nn

from dist_tpu_torch.parallel.tensor import copy_to
from dist_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, stage, stages):
        ctx.group, ctx.stage, ctx.stages = group, stage, stages
        parts = [torch.empty_like(y) for _ in range(stages)]
        dist.all_gather(parts, y.contiguous(), group=group)
        return parts[(stage - 1) % stages]

    @staticmethod
    def backward(ctx, grad):
        parts = [torch.empty_like(grad) for _ in range(ctx.stages)]
        dist.all_gather(parts, grad.contiguous(), group=ctx.group)
        return parts[(ctx.stage + 1) % ctx.stages], None, None, None


class _ReplicateSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def ring_shift(y, group, stage, stages):
    """Stage ``stage - 1``'s ``y`` (cyclically), differentiably."""
    return _RingShift.apply(y, group, stage, stages)


def replicate_sum(x, group):
    """``x`` summed over the pipe group, on every rank; the gradient
    passes through (each rank's downstream computation is the same)."""
    return _ReplicateSum.apply(x, group)


def microbatches(n, stages, requested=0):
    """``M``: the requested count (0: one per stage), clamped to the
    largest divisor of the ``n`` rows not above it, with the JAX
    package's warning when it is clamped."""
    want = int(requested) or stages
    m = max(d for d in range(1, min(want, n) + 1) if n % d == 0)
    if m < want:
        logger.warning(
            "pipeline: clamped microbatches %d -> %d (per-data-shard rows "
            "%d admit no larger divisor); bubble fraction %.0f%% -- raise "
            "the batch or lower TPU.PIPE_MICROBATCHES",
            want, m, n, 100.0 * (stages - 1) / (m + stages - 1))
    return m


def pipeline_stack(layers, x, *, group, stage, stages, n_microbatches=0,
                   collect_taps=True, run_layer=None):
    """Run ``x`` (``(N, ...)``) through the ``L`` modules of ``layers``,
    pipelined over the ``stages`` ranks of ``group`` (this rank stage
    ``stage``). Only this stage's layers, ``layers[stage L / S : (stage
    + 1) L / S]`` by their layer numbers, run here; the others may be
    :class:`HeldElsewhere`. ``run_layer(layer, x)`` runs one layer
    (default: a call; a checkpointing one under remat).

    Returns ``(y, taps)``: ``y (N, ...)`` and ``taps (L, N, ...)`` (or
    None), both the sequential stack's, on every rank."""
    run_layer = run_layer or (lambda layer, c: layer(c))
    n_layers = len(layers)
    if n_layers % stages:
        raise ValueError(f"{n_layers} layers not divisible by pipe={stages}")
    per = n_layers // stages
    # by layer number: a tap keeps its layer
    mine = [layers[i] for i in range(stage * per, (stage + 1) * per)]
    n = x.shape[0]
    m = microbatches(n, stages, n_microbatches)
    # x is every stage's, stage 0 reads it: its gradient summed over the
    # stages is the whole one, on every rank
    x = copy_to(x, group)
    xm = x.reshape((m, n // m) + tuple(x.shape[1:]))
    first = torch.tensor(stage == 0, device=x.device)
    cur = torch.zeros_like(xm[0])
    outs, taps = [None] * m, [None] * m
    # every tick's activation reaches the output with a zero weight, so
    # that every handoff's backward runs on every rank: a bubble tick's
    # result would otherwise reach the loss on some stages and not on
    # others, and their all-gathers would not meet
    anchor = cur.new_zeros(())
    for t in range(m + stages - 1):
        if t < m:
            # stage 0 injects microbatch t; the shifted value stays in the
            # graph (with a zero gradient), as the JAX package's where
            cur = torch.where(first, xm[t], cur)
        local = []
        for layer in mine:
            cur = run_layer(layer, cur)
            if collect_taps:
                local.append(cur)
        y = cur
        if y.requires_grad:
            anchor = anchor + y.sum() * 0.0
        k = t - stage
        if 0 <= k < m:
            outs[k] = y
            if collect_taps:
                taps[k] = torch.stack(local)
        if t < m + stages - 2:
            cur = ring_shift(y, group, stage, stages)
    out = torch.cat(outs) if stage == stages - 1 else torch.zeros_like(x)
    y = replicate_sum(out + anchor, group)
    if not collect_taps:
        return y, None
    own = torch.cat(taps, dim=1)                       # (L/S, N, ...)
    shape = (per,) + tuple(own.shape[1:])
    full = torch.cat(
        [own.new_zeros(shape) if s != stage else own for s in range(stages)])
    return y, replicate_sum(full, group)


class HeldElsewhere(nn.Module):
    """The place of a block that another pipe stage holds: no weights
    here, and never run on this rank."""

    def __init__(self, stage):
        super().__init__()
        self.stage = stage

    def forward(self, x):
        raise RuntimeError(f"this block is held by pipe stage {self.stage}")

    def extra_repr(self):
        return f"stage={self.stage}"


def check_model(model, lay):
    """Give the CLIP tower of ``model`` (a ``VideoModel``, its full weights
    loaded) this rank's stage of the pipe group of ``lay`` and drop every
    other stage's blocks (:class:`HeldElsewhere` in their place, so that
    each block keeps its layer number); raises for any other model and
    for a tower whose layers the stages do not divide. Records on the
    module, as ``pipe_stage``, what ``parallel/shards.py`` needs to write
    and read the full tensors: the blocks' prefix, the stages' ranks and
    the full state dict's keys, shapes and parameter order."""
    visual = getattr(model.module, "visual", None)
    tower = getattr(visual, "transformer", None)
    if tower is None or not hasattr(tower, "pipe"):
        raise ValueError("TPU.MESH.PIPE > 1 pipelines the CLIP tower "
                         "(ClipVisionTextTransformer) alone")
    n = len(tower.resblocks)
    if n % lay.pipe:
        raise ValueError(f"{n} layers not divisible by pipe={lay.pipe}")
    tower.pipe = {"group": lay.pipe_group, "stage": lay.pipe_rank,
                  "stages": lay.pipe}
    module = model.module
    per = n // lay.pipe
    module.pipe_stage = {
        "prefix": "visual.transformer.resblocks.", "per": per,
        "stage": lay.pipe_rank, "stages": lay.pipe,
        "group": lay.pipe_group, "ranks": tuple(lay.pipe_ranks),
        "shapes": {k: (tuple(v.shape), v.dtype)
                   for k, v in module.state_dict().items()},
        "names": [k for k, _ in module.named_parameters()]}
    for i in range(n):
        if i // per != lay.pipe_rank:
            tower.resblocks[i] = HeldElsewhere(i // per)
