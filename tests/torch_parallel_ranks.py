"""What the FSDP, tensor-parallel and pipeline tests run inside each rank.

``dist_tpu_torch.parallel.launch.launch_task`` starts the ranks with the
``spawn`` method, which imports the function it runs by name; these
functions live here, apart from the test files, so that a rank imports
torch and the port and never JAX. Each also runs in the test's own
process, outside any group, for the one-process reference. Each returns
plain numpy and Python values, which pickle back to the test. They run
on the CPU, or, where there is a card (the card tests), on the card the
rank is bound to (:func:`_device`)."""

import os

import numpy as np
import torch

from dist_tpu_torch.parallel import collectives as C

# a CLIP+DiST geometry that the model axis divides: widths 128, two heads
# of 64 in both towers and in the side network's pooling
WIDE = "ViT-Test-Wide"


def register_wide():
    """Add the wide tiny architecture to the port's presets (in this
    process: a spawned rank calls it itself)."""
    from dist_tpu_torch.models.clip import model as clip_model

    clip_model.ARCHITECTURES[WIDE] = clip_model.CLIPArchitecture(
        32, 64, 2, 128, 16, 77, 49408, 128, 2, 2)


def _own(t):
    """What this rank holds of ``t``: a ``DTensor``'s local shard."""
    return t.to_local() if hasattr(t, "to_local") else t


def _numpy(tensors):
    return {k: _own(v).detach().float().cpu().numpy().copy()
            for k, v in tensors.items()}


def _plain(obj):
    """``obj`` with every tensor a numpy array (a tensor does not pickle
    back from a rank that has ended)."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy().copy()
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    return obj


def _device():
    """The card this process is bound to where there is one, else the
    CPU."""
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _model(cfg, weights):
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.parallel.mesh import prepare_model

    register_wide()
    model = build_model(cfg, device=_device())
    model.module.load_state_dict({k: torch.from_numpy(v)
                                  for k, v in weights.items()})
    return prepare_model(model)


def _rows(batch, key):
    """This data shard's rows of ``batch[key]``."""
    rank, world = C.data_rank(), C.data_size()
    b = len(batch[key]) // world
    return torch.from_numpy(np.ascontiguousarray(
        batch[key][rank * b:(rank + 1) * b])).to(_device())


def _text(batch):
    t = batch.get("text_features")
    return None if t is None else torch.from_numpy(t).to(_device())


def train_steps(cfg, weights, batch, steps, out_dir=None, evals=False):
    """``steps`` train steps of the mode ``cfg`` asks for (FSDP, the model
    or pipe axis; outside a group one process), data shard r on its rows
    of ``batch``. Returns each step's mean loss, the first step's full
    trainable gradients, the full weights after, and with ``evals`` the
    eval step's and the EMA eval step's scores after each step; with
    ``out_dir`` the checkpoint after the steps is written there
    (``utils/checkpoint.py::save_checkpoint``); the elements of
    parameters and optimizer moments this rank holds."""
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.parallel import shards
    from dist_tpu_torch.parallel.fsdp import count_collectives
    from dist_tpu_torch.parallel.mesh import wrap_ddp
    from dist_tpu_torch.tasks.state import (
        create_train_state,
        ema_decay,
        make_eval_step,
        make_train_step,
    )

    model = _model(cfg, weights)
    optimizer, lr_fn = construct_optimizer(cfg, model.module, 4)
    state = create_train_state(model, optimizer, ema_decay(cfg))
    if torch.distributed.is_initialized():
        wrap_ddp(model)
    step = make_train_step(model, cfg, optimizer, lr_fn)
    eval_step = make_eval_step(model, cfg)
    ema_step = make_eval_step(model, cfg, use_ema=True)
    tb = {"video": _rows(batch, "video"),
          "labels": _rows(batch, "labels").long(),
          "text_features": _text(batch)}
    names = {id(p): k for k, p in model.module.named_parameters()}
    grads = {}

    def keep(opt, args, kwargs):
        if not grads:
            for g in opt.param_groups:
                for p in g["params"]:
                    grads[names[id(p)]] = p.grad
    hook = optimizer.register_step_pre_hook(keep)
    out = {"losses": [], "evals": [], "ema_evals": [], "collectives": []}
    for i in range(steps):
        with count_collectives() as counts:
            metrics = step(state, tb)
        out["collectives"].append(dict(counts))
        out["losses"].append(C.all_reduce_mean(float(metrics["loss"]))[0])
        if i == 0:
            out["first_weights"] = _numpy(shards.full_state_dict(model.module))
        if evals:
            ev = {"video": tb["video"], "text_features": tb["text_features"]}
            out["evals"].append(C.all_gather_arrays(
                eval_step(ev)["preds"].float().cpu().numpy())[0])
            out["ema_evals"].append(C.all_gather_arrays(
                ema_step(ev, state)["preds"].float().cpu().numpy())[0])
    hook.remove()
    module = model.module
    out["grads"] = _numpy(shards.full_state_dict(module, grads))
    out["weights"] = _numpy(shards.full_state_dict(module))
    out["local_params"] = sum(
        (p.to_local() if hasattr(p, "to_local") else p).numel()
        for p in module.parameters())
    out["total_params"] = sum(int(np.prod(s)) for s in
                              shards.global_shapes(module).values())
    out["local_moments"] = sum(
        (v.to_local() if hasattr(v, "to_local") else v).numel()
        for s in optimizer.state.values() for k, v in s.items()
        if k in ("exp_avg", "exp_avg_sq"))
    # by parameter: the elements of it and of its two moments held here
    params = dict(module.named_parameters())
    out["local_leaves"] = {k: _own(p).numel() for k, p in params.items()}
    out["local_moment_leaves"] = {
        names[id(p)]: sum(_own(v).numel() for f, v in st.items()
                          if f in ("exp_avg", "exp_avg_sq"))
        for p, st in optimizer.state.items()}
    out["pack_every_call"] = [m.pack_every_call for m in module.modules()
                              if hasattr(m, "pack_every_call")]
    if shards.pipe_info(module) is not None:
        out["held"] = _held(module, optimizer)
        out["held_ema"] = None if state.ema is None else _numpy(state.ema)
    if out_dir is not None:
        from dist_tpu_torch.utils import checkpoint as cu
        cfg.OUTPUT_DIR = out_dir
        out["checkpoint"] = cu.save_checkpoint(cfg, state, 0)
    return out


def fsdp_group(cfg, plain_cfg, weights, batch, steps, out_dir):
    """The FSDP file's one group: (a) ``train_steps`` under FSDP with its
    evals and checkpoint; (b) that checkpoint resumed by a plain state
    (every rank, no sharding) and written again by it; the FSDP state
    resumed from the plain one's file; (c) the evals with FSDP2's freed
    storage kept at its address (the CUDA caching allocator hands the
    same block back), as shipped and with the pack cache of the
    TemporalNet kept (the control)."""
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.parallel import shards
    from dist_tpu_torch.tasks.state import create_train_state, ema_decay
    from dist_tpu_torch.utils import checkpoint as cu

    out = {"fsdp": train_steps(cfg, weights, batch, steps,
                               os.path.join(out_dir, "fsdp"), evals=True)}
    # (b) FSDP -> plain -> FSDP
    plain = build_model(plain_cfg, device="cpu")
    opt, _ = construct_optimizer(plain_cfg, plain.module, 4)
    pstate = create_train_state(plain, opt, ema_decay(plain_cfg))
    pstate, _, _ = cu._resume(plain_cfg, pstate, out["fsdp"]["checkpoint"], -1)
    plain_cfg.OUTPUT_DIR = os.path.join(out_dir, "plain")
    out["plain_checkpoint"] = cu.save_checkpoint(plain_cfg, pstate, 0)
    model = _model(cfg, weights)
    opt, _ = construct_optimizer(cfg, model.module, 4)
    state = create_train_state(model, opt, ema_decay(cfg))
    state, _, _ = cu._resume(cfg, state, out["plain_checkpoint"], -1)
    out["resumed"] = {
        "weights": _numpy(shards.full_state_dict(model.module)),
        "ema": _numpy(shards.full_state_dict(model.module, state.ema)),
        "optimizer": _plain(shards.full_optimizer_state(model.module, opt)),
        "step": state.step}
    # (c) the pack cache under address reuse
    out["pack"] = {which: pack_evals(cfg, weights, batch, which)
                   for which in ("shipped", "cached")}
    return out


def round_trips(cfg, axis_cfg, plain_cfg, weights, path, out_dir):
    """The checkpoint at ``path`` (written under ``cfg``'s mesh) resumed
    and written again by a plain state (every rank whole, no sharding)
    and by a state of ``axis_cfg`` (the same mesh without ``TPU.FSDP``);
    each of their files resumed and written again by a state of
    ``cfg``. Returns the four files' paths."""
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.tasks.state import create_train_state, ema_decay
    from dist_tpu_torch.utils import checkpoint as cu

    def again(c, source, name):
        if c is plain_cfg:
            model = build_model(c, device="cpu")
        else:
            model = _model(c, weights)
        opt, _ = construct_optimizer(c, model.module, 4)
        state = create_train_state(model, opt, ema_decay(c))
        state, _, _ = cu._resume(c, state, source, -1)
        c.OUTPUT_DIR = os.path.join(out_dir, name)
        return cu.save_checkpoint(c, state, 0)

    files = {"plain": again(plain_cfg, path, "plain"),
             "axis": again(axis_cfg, path, "axis")}
    files["from_plain"] = again(cfg, files["plain"], "from_plain")
    files["from_axis"] = again(cfg, files["axis"], "from_axis")
    return files


def composed(cfg, axis_cfg, plain_cfg, weights, batch, steps, out_dir):
    """``TPU.FSDP`` with a model or pipe axis (``cfg``): ``train_steps``
    with its evals and checkpoint, then that checkpoint's
    :func:`round_trips`."""
    out = train_steps(cfg, weights, batch, steps,
                      os.path.join(out_dir, "composed"), evals=True)
    out["round_trips"] = round_trips(cfg, axis_cfg, plain_cfg, weights,
                                     out["checkpoint"], out_dir)
    return out


def submission_run(cfg):
    """The submission task on this rank's mesh (``cfg`` names the
    checkpoint and ``OUTPUT_DIR``): the results file's path (rank 0
    writes it) and, as the task scores with it, each parameter's full
    shape and the elements this rank holds of it."""
    from dist_tpu_torch.parallel import shards
    from dist_tpu_torch.tasks import submission

    register_wide()
    shapes, held = {}, {}
    forward = submission.submission_forward

    def record(cfg, model, *args):
        full = shards.global_shapes(model.module)
        for k, p in model.module.named_parameters():
            shapes[k] = tuple(full[k])
            held[k] = _own(p).numel()
        return forward(cfg, model, *args)

    submission.submission_forward = record
    try:
        path = submission.submission_test(cfg, device="cpu")
    finally:
        submission.submission_forward = forward
    return {"path": path, "shapes": shapes, "held": held}


def _held(module, optimizer):
    """{name: tensor} of the parameters this rank holds, and {name:
    {field: tensor}} of their optimizer state, as numpy."""
    names = {id(p): k for k, p in module.named_parameters()}
    moments = {names[id(p)]: {f: _own(v).detach().cpu().numpy().copy()
                              for f, v in st.items() if torch.is_tensor(v)}
               for p, st in optimizer.state.items()}
    return _numpy(dict(module.named_parameters())), moments


def pipe_checkpoints(cfg, plain_cfg, weights, batch, steps, out_dir):
    """The pipe file's checkpoint round trips, in one group: (a)
    ``train_steps`` under the pipe axis, its checkpoint written, and what
    this rank holds after the steps; (b) that checkpoint resumed by a
    fresh pipe state (what it then holds) and by a plain state (every
    rank, no pipe) which writes it again; (c) the plain state's file
    resumed by a pipe state and written again by it."""
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.tasks.state import create_train_state, ema_decay
    from dist_tpu_torch.utils import checkpoint as cu

    def fresh_pipe():
        model = _model(cfg, weights)
        opt, _ = construct_optimizer(cfg, model.module, 4)
        return create_train_state(model, opt, ema_decay(cfg))

    out = {"pipe": train_steps(cfg, weights, batch, steps,
                               os.path.join(out_dir, "pipe"))}
    # (b) pipe -> pipe, and pipe -> plain -> file
    state = fresh_pipe()
    state, _, _ = cu._resume(cfg, state, out["pipe"]["checkpoint"], -1)
    out["resumed_held"] = _held(state.model.module, state.optimizer)
    out["resumed_ema"] = _numpy(state.ema)
    plain = build_model(plain_cfg, device="cpu")
    opt, _ = construct_optimizer(plain_cfg, plain.module, 4)
    pstate = create_train_state(plain, opt, ema_decay(plain_cfg))
    pstate, _, _ = cu._resume(plain_cfg, pstate, out["pipe"]["checkpoint"],
                              -1)
    plain_cfg.OUTPUT_DIR = os.path.join(out_dir, "plain")
    out["plain_checkpoint"] = cu.save_checkpoint(plain_cfg, pstate, 0)
    # (c) plain file -> pipe -> file
    state = fresh_pipe()
    state, _, _ = cu._resume(cfg, state, out["plain_checkpoint"], -1)
    cfg.OUTPUT_DIR = os.path.join(out_dir, "pipe_again")
    out["pipe_again_checkpoint"] = cu.save_checkpoint(cfg, state, 0)
    return out


def pack_evals(cfg, weights, batch, which):
    """An eval, an EMA eval and an eval again, under FSDP with its freed
    storage kept where it was (``free_storage`` a no-op), the EMA copy
    another model's weights (each reversed, the TemporalNets' negated); ``which`` ``cached`` keeps the TemporalNet's
    pack cache on (the control). Returns the three scores."""
    from torch.distributed.fsdp._fully_shard import _fsdp_param

    from dist_tpu_torch.models.dist.dist_net import TemporalNet
    from dist_tpu_torch.parallel import shards
    from dist_tpu_torch.tasks.state import TrainState, make_eval_step

    free = _fsdp_param.free_storage
    _fsdp_param.free_storage = lambda tensor: None
    try:
        model = _model(cfg, weights)
        if which == "cached":
            for m in model.module.modules():
                if isinstance(m, TemporalNet):
                    m.pack_every_call = False
        # another model: each weight reversed, the TemporalNets' negated
        other = {k: torch.from_numpy(v).flip(0).contiguous()
                 * (-1.0 if ".temporal_nets." in k else 1.0)
                 for k, v in weights.items()}
        ema = shards.local_state_dict(model.module, other)
        ev = {"video": _rows(batch, "video"), "text_features": _text(batch)}
        state = TrainState(model=model, optimizer=None, ema=ema)
        plain = make_eval_step(model, cfg)
        with_ema = make_eval_step(model, cfg, use_ema=True)
        return [C.all_gather_arrays(s["preds"].float().numpy())[0]
                for s in (plain(ev), with_ema(ev, state), plain(ev))]
    finally:
        _fsdp_param.free_storage = free


def eval_scores(cfg, weights, batch, naive_qkv=False):
    """The eval step's scores of this data shard's rows, gathered."""
    from dist_tpu_torch.tasks.state import make_eval_step

    if naive_qkv:
        from dist_tpu_torch.models.base.models import build_model
        from dist_tpu_torch.parallel import tensor
        from dist_tpu_torch.parallel.mesh import layout
        register_wide()
        model = build_model(cfg, device="cpu")
        model.module.load_state_dict({k: torch.from_numpy(v)
                                      for k, v in weights.items()})
        tensor.shard_model(model.module, layout(), _naive_qkv=True)
    else:
        model = _model(cfg, weights)
    ev = {"video": _rows(batch, "video"), "text_features": _text(batch)}
    return C.all_gather_arrays(make_eval_step(model, cfg)(ev)["preds"]
                               .float().cpu().numpy())[0]


def group_runs(runs):
    """Each ``(function name, args)`` of ``runs`` in turn, in one group:
    their results in order."""
    import sys
    mod = sys.modules[__name__]
    return [getattr(mod, name)(*args) for name, args in runs]


def mesh_runs(runs):
    """Each ``(config, function name, args)`` of ``runs`` in turn, in one
    group, the ranks laid out as that config's mesh first
    (``parallel/mesh.py::set_layout``): their results in order."""
    import sys

    from dist_tpu_torch.parallel.mesh import set_layout
    mod = sys.modules[__name__]
    out = []
    for cfg, name, args in runs:
        set_layout(cfg)
        out.append(getattr(mod, name)(*args))
    return out


class ToyLayer(torch.nn.Module):
    """``tanh(x @ w + b) + x``: the JAX pipeline test's toy layer."""

    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w))
        self.b = torch.nn.Parameter(torch.from_numpy(b))

    def forward(self, x):
        return torch.tanh(x @ self.w + self.b) + x


def zeros_or(grad, like):
    return torch.zeros_like(like) if grad is None else grad


def pipeline_toy(w, b, x, z, cases):
    """``pipeline_stack`` over this rank's pipe group on the toy stack
    (layers from ``w`` (L, D, D) and ``b`` (L, D)), this data shard's
    rows of ``x`` (N, T, D), for each ``(microbatches, taps)`` of
    ``cases``: the output and the taps gathered over the data axis, and
    the gradients of ``sum(y ** 2) + sum(taps * z)`` (of the weights,
    summed over the data shards, and of this shard's rows of ``x``,
    gathered). Outside a group: the sequential stack."""
    from dist_tpu_torch.parallel.mesh import layout
    from dist_tpu_torch.parallel.pipeline import pipeline_stack

    lay = layout()
    layers = torch.nn.ModuleList(ToyLayer(w[i], b[i]) for i in range(len(w)))
    xs, zs = _rows({"x": x}, "x"), _rows({"z": np.moveaxis(z, 0, 1)}, "z")
    zs = zs.transpose(0, 1)
    out = []
    for mb, taps in cases:
        xr = xs.clone().requires_grad_(True)
        layers.zero_grad(set_to_none=True)
        if lay.pipe > 1:
            y, t = pipeline_stack(layers, xr, group=lay.pipe_group,
                                  stage=lay.pipe_rank, stages=lay.pipe,
                                  n_microbatches=mb, collect_taps=taps)
        else:
            c, t = xr, []
            for layer in layers:
                c = layer(c)
                t.append(c)
            y, t = c, torch.stack(t) if taps else None
        loss = (y ** 2).sum() + ((t * zs).sum() if taps else 0.0)
        loss.backward()
        # a stage's gradients live on its own rank: the others' layers
        # have none here, and the pipe group's sum is every layer's
        gw = torch.stack([zeros_or(layer.w.grad, layer.w) for layer in layers])
        gb = torch.stack([zeros_or(layer.b.grad, layer.b) for layer in layers])
        if lay.pipe > 1:
            torch.distributed.all_reduce(gw, group=lay.pipe_group)
            torch.distributed.all_reduce(gb, group=lay.pipe_group)
        if lay.data > 1:
            torch.distributed.all_reduce(gw, group=lay.data_group)
            torch.distributed.all_reduce(gb, group=lay.data_group)
        rec = {"y": C.all_gather_arrays(y.detach().numpy())[0],
               "gx": C.all_gather_arrays(xr.grad.numpy())[0],
               "gw": gw.numpy(), "gb": gb.numpy()}
        if taps:       # (N, L, T, D): gathered along the rows
            rec["taps"] = C.all_gather_arrays(
                np.moveaxis(t.detach().numpy(), 1, 0))[0]
        out.append(rec)
    return out
