"""Full tensors in and out of a sharded module (``TPU.FSDP``'s ``DTensor``
shards, ``parallel/fsdp.py``; the model axis's slices,
``parallel/tensor.py``; the pipe axis's stage, ``parallel/pipeline.py``),
so that a checkpoint written by any mode is the replicated run's file:
full tensors, the reference's keys, in the torch layout, and the
optimizer's state under its own ids. A file written under FSDP, tensor
parallelism or the pipe axis resumes in one process, and the other way
round.

Under the pipe axis a rank holds only its stage's tower blocks: each
stage's blocks, their optimizer state and their EMA copies come from
that stage's rank (a broadcast over the pipe group), and the optimizer's
ids are the ones a one-rank run gives the same parameters (its groups in
``optim/optimizer.py::GROUP_ORDER``, each group's parameters in the full
module's order). On load a rank keeps its own stage's blocks.

Under ``TPU.FSDP`` with a model or pipe axis a tensor is gathered in the
reverse of the order it was laid out in: first over the data group (the
``DTensor``'s shards; the ranks of one data group hold the same
stage and the same model slice, so they call in for the same tensors in
the same order), then over the model group or across the pipe stages. A
full tensor is laid out in the order it was sharded: the model axis's
slice or this stage's entries, then FSDP2's shard of it.

Gathering is collective: every rank of the group calls in, in the same
order, whatever rank then writes the file.
"""

import torch
import torch.distributed as dist


def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_sharded(module):
    """Whether ``module`` holds shards: FSDP2's or the model axis's."""
    from dist_tpu_torch.parallel.fsdp import is_fsdp
    from dist_tpu_torch.parallel.tensor import tp_info

    return (tp_info(module) is not None or is_fsdp(module)
            or pipe_info(module) is not None)


def pipe_info(module):
    """The pipe stage ``parallel/pipeline.py::check_model`` recorded on
    ``module``, or None."""
    return getattr(module, "pipe_stage", None)


def _stage_of(info, key):
    """The pipe stage whose blocks hold the entry ``key`` (a state-dict
    key or parameter name), or None for an entry every rank holds."""
    prefix = info["prefix"]
    if not key.startswith(prefix):
        return None
    return int(key[len(prefix):].split(".", 1)[0]) // info["per"]


def _pipe_gather(info, tensors, device, extra=None):
    """{key: tensor} of every stage's block entries of ``tensors`` (this
    rank's, keyed by state-dict key or parameter name), each from its
    stage's rank, on every rank of the pipe group, on ``device`` (the
    module's); with each stage's ``extra`` (a picklable value) in stage
    order. Collective."""
    mine = {k: v for k, v in tensors.items()
            if _stage_of(info, k) == info["stage"]}
    meta = [None] * info["stages"]
    dist.all_gather_object(
        meta, ([(k, tuple(v.shape), v.dtype) for k, v in mine.items()],
               extra), group=info["group"])
    out = {}
    for s, (entries, _) in enumerate(meta):
        for k, shape, dtype in entries:
            t = (mine[k].to(device).contiguous() if s == info["stage"]
                 else torch.empty(shape, dtype=dtype, device=device))
            dist.broadcast(t, src=info["ranks"][s], group=info["group"])
            out[k] = t
    return out, [e for _, e in meta]


def _pipe_full(info, tensors, device):
    """``tensors`` with every stage's block entries, in the full module's
    key order."""
    blocks, _ = _pipe_gather(info, tensors, device)
    full = {k: v for k, v in tensors.items() if _stage_of(info, k) is None}
    full.update(blocks)
    order = {k: i for i, k in enumerate(info["shapes"])}
    return dict(sorted(full.items(),
                       key=lambda kv: order.get(kv[0], len(order))))


def _pipe_order(info, module, optimizer):
    """The one-rank run's groups, ``[(label, parameter names)]`` in
    optimizer-id order, from every stage's groups. Collective."""
    from dist_tpu_torch.optim.optimizer import GROUP_ORDER

    names = {id(p): k for k, p in module.named_parameters()}
    own = []
    for g in optimizer.param_groups:
        if "group" not in g:
            raise ValueError("a pipe rank's optimizer needs labelled groups "
                             "(optim/optimizer.py::construct_optimizer)")
        own.append((g["group"], [names[id(p)] for p in g["params"]]))
    every = [None] * info["stages"]
    dist.all_gather_object(every, own, group=info["group"])
    members = {}
    for groups in every:
        for label, group_names in groups:
            members.setdefault(label, set()).update(group_names)
    rank = {k: i for i, k in enumerate(info["names"])}
    return [(g, sorted(members[g], key=rank.get))
            for g in GROUP_ORDER if g in members]


def _sharded_params(module):
    """FSDP2 keeps a unit's weights gathered after a forward until it is
    resharded; the shards are the module's parameters again after it."""
    from dist_tpu_torch.parallel.fsdp import is_fsdp, reshard

    if is_fsdp(module):
        reshard(module)


def _over_data(t):
    """``t`` whole over the data group: a ``DTensor``'s shards gathered
    (collective), any other tensor itself. FSDP2's ``Shard(dim)`` over a
    mesh of one dim holds ``torch.chunk``'s pieces; they are gathered, each
    padded to the first's length, by ``all_gather_into_tensor`` over the
    mesh's process group, as FSDP2 gathers (``DTensor.full_tensor``'s
    functional collectives crash gloo on CUDA tensors: a segmentation
    fault in torch 2.11 on the H100)."""
    if not isinstance(t, _dtensor()):
        return t
    (placement,) = t.placements
    local = t.to_local()
    if not placement.is_shard():
        return local
    dim = placement.dim
    group = t.device_mesh.get_group()
    world = dist.get_world_size(group)
    n = t.shape[dim]
    chunk = -(-n // world)
    local = local.movedim(dim, 0)
    if local.shape[0] < chunk:
        local = torch.cat([local, local.new_zeros(
            (chunk - local.shape[0],) + tuple(local.shape[1:]))])
    out = local.new_empty((world * chunk,) + tuple(local.shape[1:]))
    dist.all_gather_into_tensor(out, local.contiguous(), group=group)
    return out[:n].movedim(0, dim).contiguous()


def full(module, name, t):
    """The full tensor of ``t``: the parameter (or a tensor laid out as
    it) ``name`` of ``module``, gathered over the data group, then over
    the model group. Collective where it is sharded."""
    from dist_tpu_torch.parallel.tensor import gather_full

    return gather_full(module, name, _over_data(t))


def local(module, name, value, like):
    """This rank's piece of the full tensor ``value`` of ``name``, laid
    out as ``like`` (the module's own tensor): the model axis's slice,
    then, for a ``DTensor``, FSDP2's shard of it."""
    from dist_tpu_torch.parallel.tensor import local_slice

    value = local_slice(module, name, value)
    if isinstance(like, _dtensor()):
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(value.to(like.device, like.dtype),
                                 like.device_mesh, like.placements,
                                 src_data_rank=None)
    return value


def global_shapes(module):
    """{name: full shape} of ``module``'s state dict."""
    from dist_tpu_torch.parallel.tensor import full_shape

    info = pipe_info(module)
    if info is not None:
        return {k: shape for k, (shape, _) in info["shapes"].items()}
    _sharded_params(module)
    return {k: full_shape(module, k, v.shape)
            for k, v in module.state_dict().items()}


def full_state_dict(module, tensors=None):
    """``tensors`` (default the module's state dict; an EMA copy) with
    each entry full, on the CPU."""
    _sharded_params(module)
    tensors = module.state_dict() if tensors is None else tensors
    info = pipe_info(module)
    if info is not None:
        tensors = _pipe_full(info, {k: _over_data(v.detach())
                                    for k, v in tensors.items()},
                             _device(module))
    return {k: full(module, k, v).detach().cpu() for k, v in tensors.items()}


def local_state_dict(module, tensors):
    """The full ``tensors`` (a state dict of ``module``'s keys) laid out
    as the module's own, on its device; under the pipe axis without
    the blocks of the other stages."""
    info = pipe_info(module)
    if info is not None:
        tensors = {k: v for k, v in tensors.items()
                   if _stage_of(info, k) in (None, info["stage"])}
    _sharded_params(module)
    own = module.state_dict()
    return {k: local(module, k, v, own[k]) if k in own else v
            for k, v in tensors.items()}


def load_state_dict(module, tensors, strict=True):
    """``module.load_state_dict`` of full ``tensors``."""
    return module.load_state_dict(local_state_dict(module, tensors),
                                  strict=strict)


def _param_names(module, optimizer):
    names = {id(p): k for k, p in module.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def full_optimizer_state(module, optimizer):
    """``optimizer.state_dict()`` with each moment full, on the CPU."""
    info = pipe_info(module)
    if info is not None:
        return _pipe_optimizer_state(info, module, optimizer)
    _sharded_params(module)
    sd = optimizer.state_dict()
    names = _param_names(module, optimizer)
    params = dict(module.named_parameters())
    state = {}
    for i, entry in sd["state"].items():
        name = names[i]
        state[i] = {k: (full(module, name, v).detach().cpu()
                        if torch.is_tensor(v)
                        and tuple(v.shape) == tuple(params[name].shape)
                        else v) for k, v in entry.items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def _local_entries(module):
    """A function that lays out one optimizer entry of full moments
    (``(name, entry)``) as the parameter ``name`` of ``module`` is laid
    out; the entry's other fields pass as they are."""
    _sharded_params(module)
    params = dict(module.named_parameters())
    shapes = global_shapes(module)

    def laid_out(name, entry):
        return {k: (local(module, name, v, params[name])
                    if torch.is_tensor(v) and tuple(v.shape) == shapes[name]
                    else v) for k, v in entry.items()}
    return laid_out


def load_optimizer_state(module, optimizer, sd):
    """``optimizer.load_state_dict`` of a state whose moments are full."""
    info = pipe_info(module)
    if info is not None:
        return _load_pipe_optimizer_state(info, module, optimizer, sd)
    names = _param_names(module, optimizer)
    laid_out = _local_entries(module)
    state = {i: laid_out(names[int(i)], entry)
             for i, entry in sd["state"].items()}
    optimizer.load_state_dict({"state": state,
                               "param_groups": sd["param_groups"]})


def _device(module):
    return next(module.parameters()).device


def _cpu(v):
    return v.detach().cpu() if torch.is_tensor(v) else v


def _pipe_optimizer_state(info, module, optimizer):
    """The one-rank run's ``optimizer.state_dict()`` from a pipe rank's:
    every stage's entries, under the one-rank run's ids. Collective."""
    groups_order = _pipe_order(info, module, optimizer)
    order = [k for _, group in groups_order for k in group]
    sd = optimizer.state_dict()
    names = _param_names(module, optimizer)
    own = {names[i]: entry for i, entry in sd["state"].items()}
    # each entry's tensors travel as "<name>\0<field>", the rest beside;
    # a moment sharded over the data group whole first
    tensors, plain = {}, {}
    for name, entry in own.items():
        for field, v in entry.items():
            if torch.is_tensor(v):
                tensors[f"{name}\0{field}"] = _over_data(v)
            else:
                plain.setdefault(name, {})[field] = v
    groups = {g["group"]: {k: v for k, v in g.items() if k != "params"}
              for g in sd["param_groups"]}
    mine = {k: v for k, v in plain.items()
            if _stage_of(info, k) == info["stage"]}
    blocks, extras = _pipe_gather(info, tensors, _device(module),
                                  (mine, groups))
    entries = {}
    for key, v in {**{k: v for k, v in tensors.items()
                      if _stage_of(info, k) is None}, **blocks}.items():
        name, field = key.split("\0")
        entries.setdefault(name, {})[field] = v
    every_groups = {}
    for stage_plain, stage_groups in extras:
        for name, fields in stage_plain.items():
            entries.setdefault(name, {}).update(fields)
        for label, g in stage_groups.items():
            every_groups.setdefault(label, g)
    for name, fields in plain.items():
        if _stage_of(info, name) is None:
            entries.setdefault(name, {}).update(fields)
    index = {k: i for i, k in enumerate(order)}
    state = {index[name]: {k: _cpu(v) for k, v in fields.items()}
             for name, fields in sorted(entries.items(),
                                        key=lambda kv: index[kv[0]])}
    param_groups, start = [], 0
    for label, group in groups_order:
        param_groups.append({**every_groups[label],
                             "params": list(range(start, start + len(group)))})
        start += len(group)
    return {"state": state, "param_groups": param_groups}


def _load_pipe_optimizer_state(info, module, optimizer, sd):
    """``optimizer.load_state_dict`` of the one-rank run's state on a pipe
    rank: this rank's entries under its own ids. Collective."""
    order = [k for _, group in _pipe_order(info, module, optimizer)
             for k in group]
    ids = {k: i for i, k in enumerate(_param_names(module, optimizer))}
    laid_out = _local_entries(module)
    state = {ids[order[int(i)]]: laid_out(order[int(i)], entry)
             for i, entry in sd["state"].items() if order[int(i)] in ids}
    saved = {g["group"]: g for g in sd["param_groups"]}
    param_groups, start = [], 0
    for g in optimizer.param_groups:
        n = len(g["params"])
        param_groups.append({**{k: v for k, v in saved[g["group"]].items()
                                if k != "params"},
                             "params": list(range(start, start + n))})
        start += n
    optimizer.load_state_dict({"state": state, "param_groups": param_groups})
