"""The bridge from the JAX package's conv-family and transformer
variables to the port's state dict.

The JAX model's variables are ``{"params": ..., "batch_stats": ...,
"head": ...}`` trees (nested dicts of arrays, flax layouts). The port's
:class:`~dist_tpu_torch.models.base.models.BaseVideoModel` keeps the
reference's names (``backbone.conv1.a``, ``backbone.conv1.a_bn``,
``backbone.conv2.res_1.conv_branch.b_rf.g``, ``...short_cut_bn``,
``head.out``). :func:`jax_table` walks the port's module and gives, for
each entry of its state dict, the JAX collection and path it comes from;
:func:`state_dict_from_jax` converts with it, and the optimizer labels
each parameter by its JAX name through it (``optim/optimizer.py``).
"""

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch.nn as nn

from dist_tpu_torch.models.base.blocks import LayerNorm
from dist_tpu_torch.models.base.bn import BatchNorm

# parameters the JAX modules declare themselves (``self.param``), under
# the same name in both packages
_BARE = ("cls_token", "cls_token_out", "pos_embd", "temp_embd", "mask_token",
         "gamma", "dwconv_bias")

# the port's top-level child -> (JAX collection of its parameters, of its
# BatchNorm running stats)
_COLLECTIONS = {"backbone": ("params", "batch_stats"),
                "head": ("head", "head_stats")}


class JaxLeaf(NamedTuple):
    collection: str          # "params", "batch_stats", "head", ...
    path: str                # "conv1/a/conv/kernel"
    layout: str              # "conv", "dense" or "as_is"

    @property
    def name(self):
        """The name the JAX optimizer labels the leaf by: the path inside
        ``params``, else the collection and the path."""
        if self.collection == "params":
            return self.path
        return f"{self.collection}/{self.path}"


def _leaves(module):
    """{own parameter or buffer name: (JAX leaf name, layout, is a running
    stat)}; None for an entry with no JAX counterpart."""
    if isinstance(module, BatchNorm):
        return {"weight": ("scale", "as_is", False),
                "bias": ("bias", "as_is", False),
                "running_mean": ("mean", "as_is", True),
                "running_var": ("var", "as_is", True),
                "num_batches_tracked": None}
    if isinstance(module, (nn.Conv1d, nn.Conv2d, nn.Conv3d)):
        return {"weight": ("kernel", "conv", False),
                "bias": ("bias", "as_is", False)}
    if isinstance(module, nn.Linear):
        return {"weight": ("kernel", "dense", False),
                "bias": ("bias", "as_is", False)}
    if isinstance(module, LayerNorm):
        return {"weight": ("scale", "as_is", False),
                "bias": ("bias", "as_is", False)}
    return {name: (name, "as_is", False) for name in _BARE
            if name in module._parameters}


def jax_table(module) -> Dict[str, Optional[JaxLeaf]]:
    """{port state-dict key: its ``JaxLeaf``} for a ``BaseVideoModel``,
    or for one of its modules alone (its parameters in ``params``, its
    running stats in ``batch_stats``, as the JAX module's own ``init``
    gives them). None for ``num_batches_tracked``, which JAX does not
    keep. A module's ``jax_names`` maps a child to its JAX path where the
    two differ (a ConvBN site, the stem that JAX nests as ``stem``), its
    ``jax_leaf_prefix`` the JAX module that holds its own weights (the
    TAdaConv2d's ``conv/``)."""
    from dist_tpu_torch.models.base.models import BaseVideoModel

    table = {}

    def walk(mod, prefix, path, collections):
        own = dict(mod.named_parameters(recurse=False))
        own.update(mod.named_buffers(recurse=False))
        leaves = _leaves(mod)
        for name in own:
            leaf = leaves[name]
            key = prefix + name
            if leaf is None:
                table[key] = None
                continue
            jax_name, layout, is_stat = leaf
            table[key] = JaxLeaf(collections[1] if is_stat else collections[0],
                                 path + getattr(mod, "jax_leaf_prefix", "")
                                 + jax_name, layout)
        renames = getattr(mod, "jax_names", {})
        for child_name, child in mod.named_children():
            seg = renames.get(child_name, child_name)
            walk(child, f"{prefix}{child_name}.", f"{path}{seg}/", collections)

    if isinstance(module, BaseVideoModel):
        for top, collections in _COLLECTIONS.items():
            walk(getattr(module, top), f"{top}.", "", collections)
    else:
        walk(module, "", "", _COLLECTIONS["backbone"])
    return table


def jax_param_names(module) -> Dict[str, str]:
    """{port parameter name: the JAX optimizer's name for it}."""
    table = jax_table(module)
    return {k: table[k].name for k, _ in module.named_parameters()}


def _get(tree, path):
    for seg in path.split("/"):
        tree = tree[seg]
    return np.asarray(tree)


def state_dict_from_jax(variables, module) -> Dict[str, np.ndarray]:
    """The port's state dict for ``module`` (a ``BaseVideoModel`` or one
    of its modules; on the meta device will do) from the JAX model's
    variables: conv kernels
    ``(D, H, W, I, O)`` -> ``(O, I, D, H, W)``, and likewise ``(H, W, I,
    O)`` -> ``(O, I, H, W)`` and ``(K, I, O)`` -> ``(O, I, K)`` (a grouped
    conv keeps ``I = C / groups``), dense kernels ``(I, O)`` -> ``(O,
    I)``, flax BN ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
    ``running_mean``/``running_var``, ``num_batches_tracked`` 0, flax
    LayerNorm ``scale``/``bias`` -> ``weight``/``bias``, the modules' own
    parameters (``_BARE``) as they are; fp32, or float64 where the JAX
    leaf is float64."""
    out = {}
    for key, leaf in jax_table(module).items():
        if leaf is None:
            out[key] = np.zeros((), np.int64)
            continue
        x = _get(variables[leaf.collection], leaf.path)
        if leaf.layout == "conv":
            x = np.transpose(x, (x.ndim - 1, x.ndim - 2, *range(x.ndim - 2)))
        elif leaf.layout == "dense":
            x = x.T
        wide = np.float64 if x.dtype == np.float64 else np.float32
        out[key] = np.array(x, wide, order="C")
    return out
