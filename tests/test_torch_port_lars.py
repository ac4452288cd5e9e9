"""The port's LARS (``dist_tpu_torch/optim/optimizer.py::LARS``) against
the JAX package's ``optax.lars`` chain (``dist_tpu/optim/optimizer.py``),
fp32 on the CPU.

The JAX package's LARS branch flips the update's sign twice: once in
``optax.lars`` (``scale_by_learning_rate(1.0)``) and once in its outer
``scale_by_schedule(-lr)`` (``dist_tpu/optim/optimizer.py:183,234``), so
its LARS groups step up the gradient (ROADMAP.md C). The port descends.
So:

- the JAX package's own step goes up the gradient in a LARS group and
  down it in the BN group, and the port's first step is its negation in
  the LARS groups and equal in the BN group (the parameters after it at
  ``rtol=1e-6``);
- five steps of the same gradients through the port's
  ``construct_optimizer`` and through the JAX package's chain built from
  its own parts (``_core_transform``, ``param_labels``, the LR
  schedule) with the LARS branches' outer sign made a descent, on the
  simclr S3D-G config, its warm-up then its cosine (warm-up 1 epoch of 2
  steps, 4 epochs), ``ADJUST_LR`` on (the LR scaled by the batch times
  ``NUM_CLIPS_PER_VIDEO``), ``OPTIMIZER.BN_LARS_EXCLUDE`` on (the ``bn``
  group on plain SGD momentum, with ``BN.WEIGHT_DECAY``) and a leaf of
  zero norm whose first gradient is 0 too (the trust ratio's "1 where a
  norm is 0"): every parameter after each step at ``rtol=1e-6``, and
  every momentum trace at ``rtol=1e-6`` with ``atol`` 1e-6 of the
  leaf's largest entry (for entries that cancel near 0; the traces
  against optax's ``TraceState``, whose LARS branch holds the updates'
  negatives);
- the optimizer's state dict restores a LARS run bit for bit;
- the LARS groups: each group's trust-ratio flag, with and without the
  exclusion."""

import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from dist_tpu.optim import optimizer as jopt
from dist_tpu_torch.optim import optimizer as popt
from tests.test_torch_port_resnet3d import cfgs

SIMCLR = "configs/projects/hico/simclr_k400_s3dg.yaml"
OPTS = ["OPTIMIZER.MAX_EPOCH", "4", "OPTIMIZER.WARMUP_EPOCHS", "1",
        "TRAIN.NUM_FOLDS", "1", "TRAIN.BATCH_SIZE", "64",
        "OPTIMIZER.WEIGHT_DECAY", "1e-3", "BN.WEIGHT_DECAY", "1e-4",
        "TPU.MESH.DATA", "1"]
STEPS_PER_EPOCH = 2
STEPS = 5
RTOL = 1e-6
SHAPES = {"conv": {"kernel": (3, 3, 4, 8)},
          "bn": {"scale": (8,), "bias": (8,)},
          "head": {"kernel": (8, 5), "bias": (5,)}}
ZERO = ("head", "bias")          # the leaf of zero norm


class _Holder(nn.Module):
    """Parameters named as the JAX tree's leaves (``conv.kernel``)."""

    def __init__(self, tree):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Holder(v))
            else:
                self.register_parameter(k, nn.Parameter(torch.tensor(v)))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tree(fn):
    return {mod: {leaf: fn((mod, leaf), shape) for leaf, shape in d.items()}
            for mod, d in SHAPES.items()}


def _cfgs(repo_root, exclude=True):
    cfg, jcfg = cfgs(repo_root, SIMCLR, OPTS)
    for c in (cfg, jcfg):
        c.OPTIMIZER.BN_LARS_EXCLUDE = exclude
    return cfg, jcfg


def _traces(opt_state):
    """{label: (leaf path -> trace)} of optax's TraceStates, per group."""
    out = {}
    for label, inner in opt_state.inner_states.items():
        found = [s for s in jax.tree_util.tree_leaves(
            inner, is_leaf=lambda x: isinstance(x, optax.TraceState))
            if isinstance(s, optax.TraceState)]
        if found:
            out[label] = found[0].trace
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _descending_jax_chain(jcfg, variables):
    """The JAX package's ``construct_optimizer`` rebuilt from its own
    parts, with the LARS branches' outer scale ``+lr`` (``optax.lars``
    has flipped the sign already); the BN group's SGD keeps ``-lr``."""
    _, lr_for_step = jopt.construct_optimizer(jcfg, variables,
                                              STEPS_PER_EPOCH)
    exclude = bool(jcfg.OPTIMIZER.BN_LARS_EXCLUDE)

    def branch(wd, lars_exclude=False):
        sign = 1.0 if not lars_exclude else -1.0
        return optax.chain(
            jopt._core_transform(jcfg, wd, lars_exclude=lars_exclude),
            optax.scale_by_schedule(lambda c: sign * lr_for_step(c)))

    wd = float(jcfg.OPTIMIZER.WEIGHT_DECAY)
    return optax.multi_transform(
        {jopt.TRAINABLE: branch(wd), jopt.NO_WD: branch(0.0),
         jopt.BODY: branch(wd),
         jopt.BN: branch(float(jcfg.BN.WEIGHT_DECAY), lars_exclude=exclude),
         jopt.FROZEN: optax.set_to_zero()},
        jopt.param_labels(jcfg, variables)), lr_for_step


def _problem(seed):
    rng = np.random.default_rng(seed)
    params = _tree(lambda path, shape: np.zeros(shape, np.float32)
                   if path == ZERO else
                   rng.standard_normal(shape).astype(np.float32))
    grads = [_tree(lambda path, shape, step=step: np.zeros(shape, np.float32)
                   if path == ZERO and step == 0 else
                   (0.1 * rng.standard_normal(shape)).astype(np.float32))
             for step in range(STEPS)]
    return params, grads


def test_the_jax_lars_branch_steps_up_the_gradient(repo_root):
    cfg, jcfg = _cfgs(repo_root)
    params, grads = _problem(60)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    tx, _ = jopt.construct_optimizer(jcfg, variables, STEPS_PER_EPOCH)
    updates, _ = tx.update(
        {"params": jax.tree_util.tree_map(jnp.asarray, grads[0])},
        tx.init(variables), variables)
    updates = jax.device_get(updates)["params"]
    got = _run_port(cfg, params, grads, 1)[3][0][0]
    for path, g in _leaves(grads[0]):
        name = ".".join(path)
        want = np.asarray(_get(updates, path))
        p0 = _get(params, path)
        if path[0] == "bn":        # SGD momentum: down in both
            assert float((want * g).sum()) < 0, name
            np.testing.assert_allclose(got[name].numpy(), p0 + want,
                                       rtol=RTOL, atol=0, err_msg=name)
        elif path != ZERO:         # LARS: up in JAX, down in the port
            assert float((want * g).sum()) > 0, name
            np.testing.assert_allclose(got[name].numpy(), p0 - want,
                                       rtol=RTOL, atol=0, err_msg=name)


def _run_port(cfg, params, grads, steps):
    module = _Holder(params)
    optimizer, lr_fn = popt.construct_optimizer(cfg, module, STEPS_PER_EPOCH)
    named = dict(module.named_parameters())
    history = []
    for step in range(steps):
        for path, g in _leaves(grads[step]):
            named[".".join(path)].grad = torch.tensor(g)
        popt.set_lr(optimizer, lr_fn(step))
        optimizer.step()
        history.append(({k: p.detach().clone() for k, p in named.items()},
                        {k: optimizer.state[p]["momentum_buffer"].clone()
                         for k, p in named.items()}))
    return module, optimizer, lr_fn, history


def test_lars_matches_the_optax_chain(repo_root):
    cfg, jcfg = _cfgs(repo_root)
    params, grads = _problem(60)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    tx, jlr = _descending_jax_chain(jcfg, variables)
    labels = jopt.param_labels(jcfg, variables)["params"]
    assert _get(labels, ("bn", "scale")) == jopt.BN
    assert _get(labels, ("conv", "kernel")) == jopt.TRAINABLE
    opt_state = tx.init(variables)
    _, optimizer, lr_fn, history = _run_port(cfg, params, grads, STEPS)
    lars = {g["group"]: g["lars"] for g in optimizer.param_groups}
    assert lars == {popt.TRAINABLE: True, popt.BN: False}
    # ADJUST_LR: BASE_LR 0.3 x 64 videos x 2 clips / 256
    assert popt.base_lr(cfg) == pytest.approx(jopt.base_lr(jcfg))
    assert popt.base_lr(cfg) == pytest.approx(0.3 * 64 * 2 / 256)

    update = jax.jit(tx.update)
    moved = 0.0
    for step in range(STEPS):
        assert lr_fn(step) == pytest.approx(float(jlr(step)), rel=1e-6)
        g = {"params": jax.tree_util.tree_map(jnp.asarray, grads[step])}
        updates, opt_state = update(g, opt_state, variables)
        variables = optax.apply_updates(variables, updates)
        got, bufs = history[step]
        traces = _traces(opt_state)
        for path, want in _leaves(jax.device_get(variables)["params"]):
            name = ".".join(path)
            np.testing.assert_allclose(got[name].numpy(), want, rtol=RTOL,
                                       atol=0, err_msg=f"{name} step {step}")
            label = _get(labels, path)
            trace = np.asarray(_get(traces[label]["params"], path))
            # the LARS branch's trace holds the negated updates
            sign = 1.0 if label == jopt.BN else -1.0
            # entries that cancel to near 0 are held to the leaf's scale
            np.testing.assert_allclose(
                bufs[name].numpy(), sign * trace, rtol=RTOL,
                atol=RTOL * float(np.abs(trace).max()),
                err_msg=f"trace {name} step {step}")
        moved = max(moved, float(np.abs(got["conv.kernel"].numpy()
                                        - params["conv"]["kernel"]).max()))
    # the steps move the weights well past the tolerance
    assert moved > 1e-3
    zero = history[0][0]["head.bias"]
    assert torch.equal(zero, torch.zeros(5))    # u = 0: no move at step 0
    assert not torch.equal(history[1][0]["head.bias"], zero)


def test_lars_state_restores_bit_for_bit(repo_root):
    cfg, _ = _cfgs(repo_root)
    rng = np.random.default_rng(61)
    params = _tree(lambda path, shape: rng.standard_normal(shape)
                   .astype(np.float32))
    grads = [_tree(lambda path, shape: rng.standard_normal(shape)
                   .astype(np.float32)) for _ in range(STEPS)]
    _, _, _, whole = _run_port(cfg, params, grads, STEPS)

    module, optimizer, lr_fn, _ = _run_port(cfg, params, grads, 2)
    saved = {"model": {k: v.clone() for k, v in module.state_dict().items()},
             "optimizer": optimizer.state_dict()}
    resumed = _Holder(params)
    resumed.load_state_dict(saved["model"])
    opt2, _ = popt.construct_optimizer(cfg, resumed, STEPS_PER_EPOCH)
    opt2.load_state_dict(saved["optimizer"])
    named = dict(resumed.named_parameters())
    for step in range(2, STEPS):
        for path, g in _leaves(grads[step]):
            named[".".join(path)].grad = torch.tensor(g)
        popt.set_lr(opt2, lr_fn(step))
        opt2.step()
    want_params, want_bufs = whole[-1]
    for k, p in named.items():
        assert torch.equal(p, want_params[k]), k
        assert torch.equal(opt2.state[p]["momentum_buffer"], want_bufs[k]), k


@pytest.mark.parametrize("exclude", [False, True], ids=["all", "bn-excluded"])
def test_lars_groups_follow_the_bn_exclusion(repo_root, exclude):
    cfg, _ = _cfgs(repo_root, exclude)
    optimizer, _ = popt.construct_optimizer(
        cfg, _Holder(_tree(lambda p, s: np.ones(s, np.float32))), 2)
    assert isinstance(optimizer, popt.LARS)
    flags = {g["group"]: g["lars"] for g in optimizer.param_groups}
    assert flags == {popt.TRAINABLE: True, popt.BN: not exclude}
    assert all(g["nesterov"] and g["momentum"] == 0.9
               for g in optimizer.param_groups)
