"""Checkpoint intake for CLIP(+DiST) weights, and the bridge from the JAX
package's parameters (port of ``dist_tpu/models/clip/convert.py``).

The port's modules use the reference's torch names and layouts, so a
released checkpoint needs only :func:`load_torch_state_dict`'s cleanup
(``module.`` prefix, the ``ladder_net.`` -> ``dist_net.`` rename).

:func:`state_dict_from_jax` is the exact inverse of the JAX package's
``convert_clip_params`` + ``convert_dist_net``: it turns the JAX model's
params (nested dicts of arrays, per-layer weights stacked on a leading
axis, flax layouts) into this package's state dict, so that both packages
can compute with the same weights.
"""

from typing import Dict

import numpy as np
import torch


def load_torch_state_dict(path) -> Dict[str, torch.Tensor]:
    """A torch checkpoint (TorchScript archive or pickle) as fp32 tensors
    on the CPU.

    Takes ``model_state`` or ``state_dict`` from a training checkpoint,
    strips a ``module.`` prefix, renames ``ladder_net.`` to ``dist_net.``
    and drops the non-weight entries of OpenAI's archives."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:  # not a TorchScript archive
        blob = torch.load(path, map_location="cpu", weights_only=True)
        sd = blob
        if isinstance(blob, dict):
            sd = blob.get("model_state", blob.get("state_dict", blob))
    out = {}
    for k, v in sd.items():
        if not isinstance(v, torch.Tensor):
            continue
        if k.startswith("module."):
            k = k[len("module."):]
        out[k.replace("ladder_net.", "dist_net.")] = v.float()
    for drop in ("input_resolution", "context_length", "vocab_size"):
        out.pop(drop, None)
    return out


def _np(x):
    return np.array(x, order="C")  # (ascontiguousarray would make 0-d 1-d)


def _t(x):                     # flax kernel (in, out) -> torch (out, in)
    return _np(np.asarray(x).T)


def _st(x):                    # stacked transpose of the trailing 2 dims
    return _np(np.swapaxes(np.asarray(x), -1, -2))


def _conv2d(x):                # (H, W, I, O) -> (O, I, H, W)
    return _np(np.transpose(np.asarray(x), (3, 2, 0, 1)))


def _conv3d(x):                # (D, H, W, I, O) -> (O, I, D, H, W)
    return _np(np.transpose(np.asarray(x), (4, 3, 0, 1, 2)))


def _sconv3d(x):               # stacked (N, D, H, W, I, O) -> (N, O, I, D, H, W)
    return _np(np.transpose(np.asarray(x), (0, 5, 4, 1, 2, 3)))


def _unstack(sd, prefix, stacked):
    """{rest: (n, ...)} -> sd[f"{prefix}.{i}.{rest}"] = stacked[rest][i]."""
    for rest, arr in stacked.items():
        arr = np.asarray(arr)
        for i in range(arr.shape[0]):
            sd[f"{prefix}.{i}.{rest}"] = _np(arr[i])


def _ln(p):
    return {"weight": p["scale"], "bias": p["bias"]}


def _resblocks(blocks):
    """Scanned flax block params -> {rest: stacked torch-layout array}."""
    b = blocks["block"]
    a = b["attn"]
    return {
        "ln_1.weight": b["ln_1"]["scale"], "ln_1.bias": b["ln_1"]["bias"],
        "ln_2.weight": b["ln_2"]["scale"], "ln_2.bias": b["ln_2"]["bias"],
        "attn.in_proj_weight": _st(a["in_proj_weight"]),
        "attn.in_proj_bias": a["in_proj_bias"],
        "attn.out_proj.weight": _st(a["out_proj"]["kernel"]),
        "attn.out_proj.bias": a["out_proj"]["bias"],
        "mlp.c_fc.weight": _st(b["mlp"]["c_fc"]["kernel"]),
        "mlp.c_fc.bias": b["mlp"]["c_fc"]["bias"],
        "mlp.c_proj.weight": _st(b["mlp"]["c_proj"]["kernel"]),
        "mlp.c_proj.bias": b["mlp"]["c_proj"]["bias"],
    }


def _put(sd, prefix, params):
    for k, v in params.items():
        sd[f"{prefix}.{k}"] = _np(v)


def _dist_net(sd, p):
    ladder = p["ladder"]
    tn, i2t = ladder["temporal_net"], ladder["integration2temporal"]
    t2i, integ = ladder["temporal2integration"], ladder["integration_net"]
    cls = np.asarray(t2i["cls_token"])                  # (n, 1, t, C)
    _unstack(sd, "dist_net.input_linears", {
        "weight": _st(p["input_linears"]["kernel"]),
        "bias": p["input_linears"]["bias"]})
    _unstack(sd, "dist_net.temporal_nets", {
        "ln.weight": tn["ln"]["scale"], "ln.bias": tn["ln"]["bias"],
        "temporal_net.c_fc1.weight": _sconv3d(tn["c_fc1"]["kernel"]),
        "temporal_net.c_fc1.bias": tn["c_fc1"]["bias"],
        "temporal_net.c_fc2.weight": _sconv3d(tn["c_fc2"]["kernel"]),
        "temporal_net.c_fc2.bias": tn["c_fc2"]["bias"]})
    _unstack(sd, "dist_net.integration2temporal_nets", {
        "linear_fuse.weight": _st(i2t["linear_fuse"]["kernel"]),
        "linear_fuse.bias": i2t["linear_fuse"]["bias"]})
    _unstack(sd, "dist_net.temporal2integration_nets", {
        "linear_fuse.weight": _sconv3d(t2i["linear_fuse"]["kernel"]),
        "linear_fuse.bias": t2i["linear_fuse"]["bias"],
        "cls_token": cls.reshape(cls.shape[0], 1, 1, cls.shape[-2],
                                 cls.shape[-1])})
    _unstack(sd, "dist_net.integration_nets", {
        "ln.weight": integ["ln"]["scale"], "ln.bias": integ["ln"]["bias"],
        "ln_temporal.weight": integ["ln_temporal"]["scale"],
        "ln_temporal.bias": integ["ln_temporal"]["bias"],
        "ffn.c_fc.weight": _st(integ["ffn"]["c_fc"]["kernel"]),
        "ffn.c_fc.bias": integ["ffn"]["c_fc"]["bias"],
        "ffn.c_proj.weight": _st(integ["ffn"]["c_proj"]["kernel"]),
        "ffn.c_proj.bias": integ["ffn"]["c_proj"]["bias"],
        "temporal_ffn.c_fc1.weight": _sconv3d(integ["c_fc1"]["kernel"]),
        "temporal_ffn.c_fc1.bias": integ["c_fc1"]["bias"],
        "temporal_ffn.c_fc2.weight": _sconv3d(integ["c_fc2"]["kernel"]),
        "temporal_ffn.c_fc2.bias": integ["c_fc2"]["bias"],
        "temporal_ffn.c_proj.weight": _sconv3d(integ["c_proj"]["kernel"]),
        "temporal_ffn.c_proj.bias": integ["c_proj"]["bias"]})
    _put(sd, "dist_net", {
        "temporal_stem.weight": _conv3d(p["temporal_stem"]["kernel"]),
        "temporal_stem.bias": p["temporal_stem"]["bias"],
        "proj_spatial_cls_token.weight": _t(
            p["proj_spatial_cls_token"]["kernel"]),
        "proj_spatial_cls_token.bias": p["proj_spatial_cls_token"]["bias"],
        "ln_post.weight": p["ln_post"]["scale"],
        "ln_post.bias": p["ln_post"]["bias"],
        "proj": p["proj"],
        "aggregated_cls_token": p["aggregated_cls_token"],
        "aggregated_spatial_cls_token": p["aggregated_spatial_cls_token"]})
    i = 0
    while f"adapooling_{i}" in p:
        a = p[f"adapooling_{i}"]
        pre = f"dist_net.adapooling_nets.{i}"
        for name in ("temporal_transformer", "spatial_transformer"):
            m = a[name]
            _put(sd, f"{pre}.{name}", {
                "ln_1.weight": m["ln_1"]["scale"],
                "ln_1.bias": m["ln_1"]["bias"],
                "attn.in_proj_weight": _t(m["attn"]["in_proj_weight"]),
                "attn.in_proj_bias": m["attn"]["in_proj_bias"],
                "attn.out_proj.weight": _t(m["attn"]["out_proj"]["kernel"]),
                "attn.out_proj.bias": m["attn"]["out_proj"]["bias"]})
        for name in ("output_map_cls_token", "output_map_spatial_cls_token"):
            _put(sd, f"{pre}.{name}", {
                "c_fc.weight": _t(a[name]["c_fc"]["kernel"]),
                "c_fc.bias": a[name]["c_fc"]["bias"],
                "c_proj.weight": _t(a[name]["c_proj"]["kernel"]),
                "c_proj.bias": a[name]["c_proj"]["bias"]})
        _put(sd, pre, {
            "positional_embedding": a["positional_embedding"],
            "ln_out_temp_cls_token.weight": a["ln_out_temp_cls_token"]["scale"],
            "ln_out_temp_cls_token.bias": a["ln_out_temp_cls_token"]["bias"],
            "ln_out_spat_cls_token.weight": a["ln_out_spat_cls_token"]["scale"],
            "ln_out_spat_cls_token.bias": a["ln_out_spat_cls_token"]["bias"]})
        i += 1


def state_dict_from_jax(flax_params) -> Dict[str, np.ndarray]:
    """The JAX package's CLIP(+DiST) params -> this package's state dict
    (numpy arrays under the reference's torch key names). Given the whole
    variables (``{"params": ..., "head": ...}``), a head with weights
    (``ClipVideoHeadLinear``'s ``out`` Dense) comes across too, as
    ``head.out.weight`` (the kernel transposed) and ``head.out.bias``."""
    p = flax_params
    head = None
    if "params" in p:
        head, p = p.get("head"), p["params"]
    v, t = p["visual"], p["text"]
    sd = {"logit_scale": _np(p["logit_scale"]).reshape(())}
    _put(sd, "visual", {
        "class_embedding": v["class_embedding"],
        "positional_embedding": v["positional_embedding"],
        "proj": v["proj"],
        "conv1.weight": _conv2d(v["conv1"]["kernel"]),
        **{f"ln_pre.{k}": x for k, x in _ln(v["ln_pre"]).items()},
        **{f"ln_post.{k}": x for k, x in _ln(v["ln_post"]).items()}})
    _unstack(sd, "visual.transformer.resblocks", _resblocks(v["resblocks"]))
    sd["token_embedding.weight"] = _np(t["token_embedding"])
    sd["positional_embedding"] = _np(t["positional_embedding"])
    sd["text_projection"] = _np(t["text_projection"])
    sd["ln_final.weight"] = _np(t["ln_final"]["scale"])
    sd["ln_final.bias"] = _np(t["ln_final"]["bias"])
    _unstack(sd, "transformer.resblocks", _resblocks(t["resblocks"]))
    if "dist_net" in p:
        _dist_net(sd, p["dist_net"])
    if head:
        sd["head.out.weight"] = _t(head["out"]["kernel"])
        sd["head.out.bias"] = _np(head["out"]["bias"])
    return sd


def to_torch(state_dict):
    """numpy state dict -> torch tensors (for ``load_state_dict``)."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in state_dict.items()}
