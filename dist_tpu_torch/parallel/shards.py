"""Full tensors in and out of a sharded module (``TPU.FSDP``'s ``DTensor``
shards, ``parallel/fsdp.py``; the model axis's slices,
``parallel/tensor.py``), so that a checkpoint written by any mode is the
replicated run's file: full tensors, the reference's keys, in the torch
layout, and the optimizer's state under its own ids. A file written
under FSDP or tensor parallelism resumes in one process, and the other
way round.

Gathering is collective: every rank of the group calls in, in the same
order, whatever rank then writes the file.
"""

import torch


def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_sharded(module):
    """Whether ``module`` holds shards: FSDP2's or the model axis's."""
    from dist_tpu_torch.parallel.fsdp import is_fsdp
    from dist_tpu_torch.parallel.tensor import tp_info

    return tp_info(module) is not None or is_fsdp(module)


def _sharded_params(module):
    """FSDP2 keeps a unit's weights gathered after a forward until it is
    resharded; the shards are the module's parameters again after it."""
    from dist_tpu_torch.parallel.fsdp import is_fsdp, reshard

    if is_fsdp(module):
        reshard(module)


def full(module, name, t):
    """The full tensor of ``t``: the parameter (or a tensor laid out as
    it) ``name`` of ``module``. Collective where it is sharded."""
    from dist_tpu_torch.parallel.tensor import gather_full

    if isinstance(t, _dtensor()):
        t = t.full_tensor()
    return gather_full(module, name, t)


def local(module, name, value, like):
    """This rank's piece of the full tensor ``value`` of ``name``, laid
    out as ``like`` (the module's own tensor): a ``DTensor`` of its
    placements, or the model axis's slice."""
    from dist_tpu_torch.parallel.tensor import local_slice

    dt = _dtensor()
    if isinstance(like, dt):
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(value.to(like.device, like.dtype),
                                 like.device_mesh, like.placements,
                                 src_data_rank=None)
    return local_slice(module, name, value)


def global_shapes(module):
    """{name: full shape} of ``module``'s state dict."""
    from dist_tpu_torch.parallel.tensor import full_shape

    _sharded_params(module)
    return {k: full_shape(module, k, v.shape)
            for k, v in module.state_dict().items()}


def full_state_dict(module, tensors=None):
    """``tensors`` (default the module's state dict; an EMA copy) with
    each entry full, on the CPU."""
    _sharded_params(module)
    tensors = module.state_dict() if tensors is None else tensors
    return {k: full(module, k, v).detach().cpu() for k, v in tensors.items()}


def local_state_dict(module, tensors):
    """The full ``tensors`` (a state dict of ``module``'s keys) laid out
    as the module's own, on its device."""
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


def load_optimizer_state(module, optimizer, sd):
    """``optimizer.load_state_dict`` of a state whose moments are full."""
    _sharded_params(module)
    names = _param_names(module, optimizer)
    params = dict(module.named_parameters())
    shapes = global_shapes(module)
    state = {}
    for i, entry in sd["state"].items():
        name = names[int(i)]
        state[i] = {k: (local(module, name, v, params[name])
                        if torch.is_tensor(v)
                        and tuple(v.shape) == shapes[name] else v)
                    for k, v in entry.items()}
    optimizer.load_state_dict({"state": state,
                               "param_groups": sd["param_groups"]})
