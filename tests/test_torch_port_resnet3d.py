"""The port's 3D-ResNet family (``dist_tpu_torch/models/backbones/
resnet3d.py``) against the JAX package's on the CPU: every stem, and
every branch in each of its transformations (and ``NonLocal``) inside a
two-block res-stage, in eval mode in fp32, on the same seeded inputs and
the same JAX weights brought across by ``models/backbones/convert.py``.
Tolerance ``atol=2e-4, rtol=1e-4``, that of ``tests/test_conv_goldens.py``.

The JAX weights are drawn from a seed in the JAX layout over the shapes
of the JAX module's own ``init`` (``jax.eval_shape``), with the zero
inits drawn too (the route function's ``b``, ``b_avgpool_bn`` and
``NonLocal.bn`` scales) and running stats away from (0, 1), so that no
part of the path is the identity. ``tests/test_torch_port_tada.py``
imports the helpers here."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dist_tpu.config import load_config as jax_load_config
from dist_tpu.models.backbones import resnet3d as jr
from dist_tpu.models.base.models import build_model as jax_build_model
from dist_tpu_torch.config import load_config
from dist_tpu_torch.models.backbones import resnet3d as pr
from dist_tpu_torch.models.backbones.convert import jax_table, state_dict_from_jax
from dist_tpu_torch.models.base import models as pm

TOL = dict(atol=2e-4, rtol=1e-4)
WIDTHS = ["VIDEO.BACKBONE.NUM_FILTERS", "[8, 16, 32, 64, 128]"]
TADA_CONFIGS = ["tada2d_k400.yaml", "k400/tada2d_8x8.yaml",
                "k400/tada2d_16x5.yaml", "tada2d_ssv2.yaml",
                "ssv2/tada2d_8f.yaml", "ssv2/tada2d_16f.yaml"]


def cfgs(repo_root, path, opts=()):
    """(port cfg, JAX cfg) of one yaml with ``opts``."""
    path = os.path.join(repo_root, path)
    return (load_config(path, list(opts), make_output_dir=False),
            jax_load_config(path, list(opts), make_output_dir=False))


def _draw(path, shape, rng):
    name = path[-1]
    if name == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        return rng.normal(0.0, (2.0 / fan_in) ** 0.5, shape)
    if name == "scale":
        return rng.uniform(0.5, 1.5, shape)
    if name in ("bias", "mean"):
        return rng.normal(0.0, 0.1, shape)
    if name == "var":
        return rng.uniform(0.5, 2.0, shape)
    raise KeyError("/".join(path))


def jax_variables(jmod, seed, *args, **kwargs):
    """Seeded numpy variables over the tree of ``jmod.init(key, *args,
    **kwargs)``, without running the init: He-scaled kernels (zero-init
    ones included), BN scales in [0.5, 1.5), biases and running means
    N(0, 0.1), running variances in [0.5, 2)."""
    shapes = jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        keys = tuple(str(getattr(p, "key", p)) for p in path)
        return _draw(keys, s.shape, rng).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def load_jax(module, variables):
    """``module`` with the JAX ``variables`` (strict: every entry of its
    state dict has its counterpart)."""
    sd = state_dict_from_jax(variables, module)
    module.load_state_dict({k: torch.from_numpy(np.asarray(v))
                            for k, v in sd.items()})
    return module


def to_ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 4, 1, 2, 3))))


def from_ncdhw(y):
    return np.transpose(y.detach().float().numpy(), (0, 2, 3, 4, 1))


def port_module(cls, *args):
    """A port module built on the meta device and given storage, as
    ``build_model`` builds one."""
    with torch.device("meta"):
        mod = cls(*args)
    return mod.to_empty(device="cpu")


STEMS = ["Base2DStem", "Base3DStem", "DownSampleStem", "R2Plus1DStem"]
# (branch, DEPTH: 18 a simple block, 50 a bottleneck, non-local stage)
BRANCHES = [("R2Plus1DBranch", 18, False), ("R2Plus1DBranch", 50, False),
            ("R2D3DBranch", 18, False), ("R2D3DBranch", 50, False),
            ("CSNBranch", 50, False), ("SimpleBranch", 18, False),
            ("SimpleBranch", 50, False), ("TAdaConvBlockAvgPool", 50, False),
            ("SimpleBranch", 18, True)]
SPACE_ONLY = (("SimpleBranch", 50), ("TAdaConvBlockAvgPool", 50))
CASES = ([("stem", s, 18, False) for s in STEMS]
         + [("branch",) + b for b in BRANCHES])


def _case_cfg(repo_root, kind, name, depth, nonlocal_on):
    base = ("configs/pool/backbone/tada2d.yaml"
            if name == "TAdaConvBlockAvgPool"
            else "configs/pool/backbone/r2p1d.yaml")
    opts = WIDTHS + ["VIDEO.BACKBONE.DEPTH", str(depth),
                     "VIDEO.BACKBONE.NONLOCAL.ENABLE", str(nonlocal_on).lower(),
                     "VIDEO.BACKBONE.NONLOCAL.STAGES", "[3]",
                     # T strided by 2 too: in the stem where its kernel
                     # allows, in stage 2 but for the TAda block and
                     # SimpleBranch's bottleneck, whose convs stride space
                     # only in both packages (the shortcut would not match)
                     "VIDEO.BACKBONE.DOWNSAMPLING_TEMPORAL",
                     "[true, false, %s, true, true]" % str(
                         (name, depth) not in SPACE_ONLY).lower()]
    opts += (["VIDEO.BACKBONE.STEM.NAME", name] if kind == "stem"
             else ["VIDEO.BACKBONE.BRANCH.NAME", name])
    return cfgs(repo_root, base, opts)


@pytest.mark.parametrize("kind,name,depth,nonlocal_on", CASES, ids=[
    f"{c[1]}-{c[2]}{'-nonlocal' if c[3] else ''}" for c in CASES])
def test_stem_and_branch_eval_match_jax(repo_root, kind, name, depth,
                                        nonlocal_on):
    """A stem on (2, 4, 16, 16, 3); a branch inside a two-block res-stage
    (stage 2: 16 -> 32 channels, stride (2, 2, 2) or (1, 2, 2), so the first block
    has the ConvBN shortcut and the second the identity) on (2, 4, 8, 8,
    16); the non-local case adds ``NonLocal`` after the stage."""
    cfg, jcfg = _case_cfg(repo_root, kind, name, depth, nonlocal_on)
    rng = np.random.default_rng(
        CASES.index((kind, name, depth, nonlocal_on)))
    if kind == "stem":
        x = rng.standard_normal((2, 4, 16, 16, 3)).astype(np.float32)
        jmod = getattr(jr, name)(jcfg)
        mod = port_module(getattr(pr, name), cfg)
    else:
        x = rng.standard_normal((2, 4, 8, 8, 16)).astype(np.float32)
        jmod = jr.Base3DResStage(jcfg, 2, 2)
        mod = port_module(pr.Base3DResStage, cfg, 2, 2)
    variables = jax_variables(jmod, 1, jnp.asarray(x), train=False)
    want = jmod.apply(variables, jnp.asarray(x), train=False)
    load_jax(mod, variables).eval()
    with torch.no_grad():
        got = from_ncdhw(mod(to_ncdhw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def assert_tree_maps_one_to_one(repo_root, path, frames, crop, opts=()):
    """The config at full width on the meta device: every entry of the
    port's state dict has its JAX leaf at the shape the layout implies,
    and every JAX leaf one entry. Returns (module, weights)."""
    cfg, jcfg = cfgs(repo_root, path, opts)
    module = pm.build_backbone_on_meta(cfg)
    assert isinstance(module, pm.BaseVideoModel)
    shapes = jax.eval_shape(lambda: jax_build_model(jcfg).init(
        jax.random.PRNGKey(0),
        {"video": jnp.zeros((1, frames, crop, crop, 3), jnp.float32)}))
    flat = {}
    for coll, tree in shapes.items():
        for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[(coll, "/".join(str(q.key) for q in p))] = leaf.shape
    sd = module.state_dict()
    table = jax_table(module)
    assert set(table) == set(sd)
    seen = set()
    for key, leaf in table.items():
        if leaf is None:
            assert key.endswith("num_batches_tracked")
            continue
        shape = flat[(leaf.collection, leaf.path)]
        if leaf.layout == "conv":
            shape = tuple(shape[i] for i in (4, 3, 0, 1, 2))
        elif leaf.layout == "dense":
            shape = shape[::-1]
        assert tuple(sd[key].shape) == tuple(shape), key
        assert (leaf.collection, leaf.path) not in seen, key
        seen.add((leaf.collection, leaf.path))
    assert seen == set(flat)
    n = sum(p.numel() for p in module.parameters())
    assert n == sum(int(np.prod(s)) for (c, _), s in flat.items()
                    if c in ("params", "head"))
    return module, n


def test_full_width_tada2d_matches_the_jax_tree(repo_root):
    """TAda2D-R50 8x8 K400 at full width, on the meta device: every
    entry of the port's state dict has its JAX counterpart at the shape
    the layout implies, and every JAX leaf has one entry (27.5 M
    weights)."""
    _, n = assert_tree_maps_one_to_one(
        repo_root, "configs/projects/tada/k400/tada2d_8x8.yaml", 8, 224)
    assert 27.4e6 < n < 27.6e6


@pytest.mark.parametrize("name", TADA_CONFIGS)
def test_build_model_builds_every_tada_config_on_the_cpu(repo_root, name):
    """Every config under ``configs/projects/tada/`` whose head is
    ``BaseHead`` builds with ``device="cpu"``: the backbone and the head
    inside one module, in eval mode, no text tower; for 8x8 the
    BatchNorm running stats at (0, 1), the ``b_avgpool_bn`` scales and
    the route functions' ``b`` at zero and ConvBN's He init. Without a
    device it raises on a host with no card."""
    cfg, _ = cfgs(repo_root, f"configs/projects/tada/{name}")
    model = pm.build_model(cfg, device="cpu")
    assert isinstance(model.module, pm.BaseVideoModel)
    assert model.head is None and not model.module.training
    assert model.module.head.out.out_features == int(
        cfg.VIDEO.HEAD.NUM_CLASSES)
    assert not model.is_text_model
    if name == "k400/tada2d_8x8.yaml":
        sd = model.module.state_dict()
        for k, v in sd.items():
            if k.endswith("running_mean") or k.endswith("b_avgpool_bn.weight") \
                    or k.endswith("b_rf.b.weight"):
                assert not v.any(), k
            elif k.endswith("running_var"):
                assert bool((v == 1).all()), k
        w = sd["backbone.conv1.a.weight"]
        std = (2.0 / w[0].numel()) ** 0.5
        assert abs(float(w.std()) / std - 1) < 0.05
        assert float(w.abs().max()) <= 2 * std / .87962566103423978 + 1e-6
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pm.build_model(cfg)


def test_pop_head_drops_the_head_on_a_fine_tune_load(repo_root, tmp_path):
    """``TRAIN.CHECKPOINT_PRE_PROCESS.POP_HEAD`` with ``FINE_TUNE``: a
    fine-tune load of a TAda2D checkpoint takes the backbone and its
    running stats and keeps the fresh ``head.*``."""
    from dist_tpu_torch.utils.checkpoint import load_torch_weights

    opts = WIDTHS + ["VIDEO.BACKBONE.DEPTH", "18", "VIDEO.HEAD.NUM_CLASSES",
                     "7", "TRAIN.FINE_TUNE", "true",
                     "TRAIN.CHECKPOINT_PRE_PROCESS.ENABLE", "true",
                     "TRAIN.CHECKPOINT_PRE_PROCESS.POP_HEAD", "true"]
    cfg, _ = cfgs(repo_root, "configs/projects/tada/k400/tada2d_8x8.yaml",
                  opts)
    source = pm.build_model(cfg, device="cpu", seed=1).module.state_dict()
    source = {k: v + 1 if v.is_floating_point() else v
              for k, v in source.items()}
    path = str(tmp_path / "source.pyth")
    torch.save({"model_state": source}, path)
    model = pm.build_model(cfg, device="cpu", seed=2)
    fresh = {k: v.clone() for k, v in model.module.state_dict().items()}
    load_torch_weights(model, path, cfg)
    for k, v in model.module.state_dict().items():
        want = fresh[k] if k.startswith("head.") else source[k]
        assert torch.equal(v, want.to(v.dtype)), k
