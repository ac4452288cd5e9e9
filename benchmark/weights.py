"""What a run is given, made from ``--seed`` on the run's device: the
weights in the reference checkpoint's key names and layouts, the label
texts as token ids, and clips and labels.

The weights are a frozen copy of the repository's synthetic-checkpoint
generator (every weight N(0, 0.02), LayerNorm scales 1 + N(0, 0.02),
CLIP's logit scale log(1 / 0.07)) at the configuration's widths, drawn
in one call on the device and cut into leaves, in fp32, the type the
program holds its weights in. The same seed gives the same tensors to the
program and to the reference."""

import math

import numpy as np
import torch

SOT, EOT = 49406, 49407


def _block(shapes, p, d):
    for name in ("ln_1", "ln_2"):
        shapes[f"{p}.{name}.weight"] = ("ln", (d,))
        shapes[f"{p}.{name}.bias"] = ("r", (d,))
    shapes[f"{p}.attn.in_proj_weight"] = ("r", (3 * d, d))
    shapes[f"{p}.attn.in_proj_bias"] = ("r", (3 * d,))
    shapes[f"{p}.attn.out_proj.weight"] = ("r", (d, d))
    shapes[f"{p}.attn.out_proj.bias"] = ("r", (d,))
    _mlp(shapes, f"{p}.mlp", d, 4)


def _mha(shapes, p, d):
    shapes[f"{p}.ln_1.weight"] = ("ln", (d,))
    shapes[f"{p}.ln_1.bias"] = ("r", (d,))
    shapes[f"{p}.attn.in_proj_weight"] = ("r", (3 * d, d))
    shapes[f"{p}.attn.in_proj_bias"] = ("r", (3 * d,))
    shapes[f"{p}.attn.out_proj.weight"] = ("r", (d, d))
    shapes[f"{p}.attn.out_proj.bias"] = ("r", (d,))


def _mlp(shapes, p, d, ratio):
    shapes[f"{p}.c_fc.weight"] = ("r", (ratio * d, d))
    shapes[f"{p}.c_fc.bias"] = ("r", (ratio * d,))
    shapes[f"{p}.c_proj.weight"] = ("r", (d, ratio * d))
    shapes[f"{p}.c_proj.bias"] = ("r", (d,))


def _ln(shapes, p, d):
    shapes[f"{p}.weight"] = ("ln", (d,))
    shapes[f"{p}.bias"] = ("r", (d,))


def layout(spec):
    """{key: (kind, shape)} in the generator's order; kind ``r`` is
    N(0, 0.02), ``ln`` 1 + N(0, 0.02), ``scale`` CLIP's logit scale."""
    a = spec["arch"]
    s = {}
    vw, ps = a["vision_width"], a["vision_patch_size"]
    grid = a["image_resolution"] // ps
    s["visual.conv1.weight"] = ("r", (vw, 3, ps, ps))
    s["visual.class_embedding"] = ("r", (vw,))
    s["visual.positional_embedding"] = ("r", (grid * grid + 1, vw))
    s["visual.proj"] = ("r", (vw, a["embed_dim"]))
    _ln(s, "visual.ln_pre", vw)
    _ln(s, "visual.ln_post", vw)
    for i in range(a["vision_layers"]):
        _block(s, f"visual.transformer.resblocks.{i}", vw)
    tw = a["transformer_width"]
    s["token_embedding.weight"] = ("r", (a["vocab_size"], tw))
    s["positional_embedding"] = ("r", (a["context_length"], tw))
    s["text_projection"] = ("r", (tw, a["embed_dim"]))
    _ln(s, "ln_final", tw)
    for i in range(a["transformer_layers"]):
        _block(s, f"transformer.resblocks.{i}", tw)
    s["logit_scale"] = ("scale", ())
    if spec.get("dist"):
        _dist(s, spec["dist"], vw, a["embed_dim"])
    if spec["head"] == "linear":
        s["head.out.weight"] = ("r", (spec["classes"], a["embed_dim"]))
        s["head.out.bias"] = ("r", (spec["classes"],))
    return s


def _dist(s, d, d_model, embed_dim):
    c, ct, k = d["integration_dim"], d["temporal_dim"], d["temporal_kernel_size"]
    tt = d["num_frames"] // d["alpha"]
    h_t = int(ct * d["temporal_conv_mlp_ratio"])
    h_it = int(c * d["integration_temporal_mlp_ratio"])
    s["dist_net.temporal_stem.weight"] = (
        "r", (ct, 3, d["t_patch_size"], d["s_patch_size"], d["s_patch_size"]))
    s["dist_net.temporal_stem.bias"] = ("r", (ct,))
    for i in range(len(d["selected_layers"])):
        s[f"dist_net.input_linears.{i}.weight"] = ("r", (c, d_model))
        s[f"dist_net.input_linears.{i}.bias"] = ("r", (c,))
        p = f"dist_net.temporal_nets.{i}"
        _ln(s, f"{p}.ln", ct)
        s[f"{p}.temporal_net.c_fc1.weight"] = ("r", (h_t, ct, k, 1, 1))
        s[f"{p}.temporal_net.c_fc1.bias"] = ("r", (h_t,))
        s[f"{p}.temporal_net.c_fc2.weight"] = ("r", (ct, h_t, 1, 3, 3))
        s[f"{p}.temporal_net.c_fc2.bias"] = ("r", (ct,))
        p = f"dist_net.integration2temporal_nets.{i}"
        s[f"{p}.linear_fuse.weight"] = ("r", (ct, c))
        s[f"{p}.linear_fuse.bias"] = ("r", (ct,))
        p = f"dist_net.temporal2integration_nets.{i}"
        s[f"{p}.linear_fuse.weight"] = ("r", (c, ct, d["alpha"], 1, 1))
        s[f"{p}.linear_fuse.bias"] = ("r", (c,))
        s[f"{p}.cls_token"] = ("r", (1, 1, tt, c))
        p = f"dist_net.integration_nets.{i}"
        _ln(s, f"{p}.ln", c)
        _ln(s, f"{p}.ln_temporal", c)
        _mlp(s, f"{p}.ffn", c, int(d["integration_mlp_ratio"]))
        s[f"{p}.temporal_ffn.c_fc1.weight"] = ("r", (h_it, c, 1, 1, 1))
        s[f"{p}.temporal_ffn.c_fc1.bias"] = ("r", (h_it,))
        s[f"{p}.temporal_ffn.c_fc2.weight"] = ("r", (h_it, h_it, k, 1, 1))
        s[f"{p}.temporal_ffn.c_fc2.bias"] = ("r", (h_it,))
        s[f"{p}.temporal_ffn.c_proj.weight"] = ("r", (c, h_it, 1, 1, 1))
        s[f"{p}.temporal_ffn.c_proj.bias"] = ("r", (c,))
    for i in range(d["ada_pooling_layers"]):
        p = f"dist_net.adapooling_nets.{i}"
        _mha(s, f"{p}.temporal_transformer", c)
        _mha(s, f"{p}.spatial_transformer", c)
        s[f"{p}.positional_embedding"] = ("r", (1, tt, c))
        _mlp(s, f"{p}.output_map_cls_token", c, 4)
        _mlp(s, f"{p}.output_map_spatial_cls_token", c, 4)
        _ln(s, f"{p}.ln_out_temp_cls_token", c)
        _ln(s, f"{p}.ln_out_spat_cls_token", c)
    s["dist_net.proj_spatial_cls_token.weight"] = ("r", (c, d_model))
    s["dist_net.proj_spatial_cls_token.bias"] = ("r", (c,))
    _ln(s, "dist_net.ln_post", c)
    s["dist_net.proj"] = ("r", (c, embed_dim))
    s["dist_net.aggregated_cls_token"] = ("r", (1, 1, c))
    s["dist_net.aggregated_spatial_cls_token"] = ("r", (1, 1, c))


def count(spec):
    """The number of weights."""
    return sum(math.prod(shape) for _, shape in layout(spec).values())


def make_weights(spec, seed, device):
    """{key: fp32 tensor on ``device``}: one draw of N(0, 1) for every
    weight, cut into leaves (views of that one buffer)."""
    lay = layout(spec)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(count(spec), generator=gen, device=device)
    flat.mul_(0.02)
    out, at = {}, 0
    for key, (kind, shape) in lay.items():
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape)
        at += n
        if kind == "ln":
            leaf.add_(1.0)
        elif kind == "scale":
            leaf.fill_(math.log(1.0 / 0.07))
        out[key] = leaf
    return out


def make_tokens(spec, seed, device):
    """Label texts as CLIP token ids (classes, context): start, 4 to 16
    words below the end token, the end token (the largest id, which the
    towers read), zeros after."""
    a = spec["arch"]
    rng = np.random.default_rng([int(seed), 1])
    tok = np.zeros((spec["classes"], a["context_length"]), np.int64)
    for i in range(spec["classes"]):
        n = int(rng.integers(4, 17))
        tok[i, 0] = SOT
        tok[i, 1:n + 1] = rng.integers(1, SOT, n)
        tok[i, n + 1] = EOT
    return torch.from_numpy(tok).to(device)


def make_clips(n, frames, size, seed, device):
    """uint8 clips (n, frames, size, size, 3) drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randint(0, 256, (n, frames, size, size, 3), generator=gen,
                         device=device, dtype=torch.uint8)


def make_labels(n, classes, seed, device):
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randint(0, classes, (n,), generator=gen, device=device)
