"""The plain reference of the benchmark's models: CLIP's towers, DiST's
side network and both classifiers, as functions of a state dict in the
reference checkpoint's key names and layouts (``weights.py``).

A frozen copy of the repository's functional golden model (the torch
modules of the DiST release, written with ``torch.nn.functional``), with
every product routed through a :class:`precision.Precision` and the
attention written out (scaled query, softmax, values), so that the
control can round every operand. It imports nothing of the program.
Sequences are (L, N, E), as in the release."""

import math

import torch
import torch.nn.functional as F


def qg(x):
    return x * torch.sigmoid(1.702 * x)


def ln(x, w, p):
    return F.layer_norm(x, (x.shape[-1],), w[f"{p}.weight"], w[f"{p}.bias"])


def mlp(P, x, w, p):
    x = qg(P.linear(x, w[f"{p}.c_fc.weight"], w[f"{p}.c_fc.bias"]))
    return P.linear(x, w[f"{p}.c_proj.weight"], w[f"{p}.c_proj.bias"])


def mha(P, q_in, kv_in, w, p, heads, causal=False):
    """``nn.MultiheadAttention`` on (Lq, N, E) queries and (Lk, N, E)
    keys and values: in-projection, softmax(q k^T / sqrt(d)) v, out
    projection."""
    e = q_in.shape[-1]
    wi, bi = w[f"{p}.attn.in_proj_weight"], w[f"{p}.attn.in_proj_bias"]
    q = P.linear(q_in, wi[:e], bi[:e])
    k = P.linear(kv_in, wi[e:2 * e], bi[e:2 * e])
    v = P.linear(kv_in, wi[2 * e:], bi[2 * e:])
    lq, n, _ = q.shape
    lk = k.shape[0]
    hd = e // heads

    def split(x, l):
        return x.reshape(l, n * heads, hd).transpose(0, 1)   # (N*h, L, hd)

    q, k, v = split(q, lq) * (hd ** -0.5), split(k, lk), split(v, lk)
    s = P.matmul(q, k.transpose(1, 2))
    if causal:
        mask = torch.ones(lq, lk, dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(mask, float("-inf"))
    o = P.matmul(torch.softmax(s, dim=-1), v)
    o = o.transpose(0, 1).reshape(lq, n, e)
    return P.linear(o, w[f"{p}.attn.out_proj.weight"],
                    w[f"{p}.attn.out_proj.bias"])


def resblock(P, x, w, p, heads, causal=False):
    h = ln(x, w, f"{p}.ln_1")
    x = x + mha(P, h, h, w, p, heads, causal)
    return x + mlp(P, ln(x, w, f"{p}.ln_2"), w, f"{p}.mlp")


def visual_tower(P, frames, w, arch, keep_taps):
    """CLIP's ViT over kept frames (N, 3, H, W) -> (embedding (N, E),
    taps: per layer (L, N, width), or an empty list)."""
    ps = arch["vision_patch_size"]
    x = P.conv2d(frames, w["visual.conv1.weight"], None, stride=ps)
    x = x.reshape(x.shape[0], x.shape[1], -1).permute(0, 2, 1)
    cls = w["visual.class_embedding"].reshape(1, 1, -1).expand(
        x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + w["visual.positional_embedding"]
    x = ln(x, w, "visual.ln_pre").permute(1, 0, 2)
    taps = []
    for i in range(arch["vision_layers"]):
        x = resblock(P, x, w, f"visual.transformer.resblocks.{i}",
                     arch["vision_heads"])
        if keep_taps:
            taps.append(x)
    cls_out = ln(x[0], w, "visual.ln_post")
    return P.matmul(cls_out, w["visual.proj"]), taps


def text_tower(P, tokens, w, arch):
    """Label texts (N, context) int -> features (N, E)."""
    x = F.embedding(tokens, w["token_embedding.weight"])
    x = (x + w["positional_embedding"]).permute(1, 0, 2)
    for i in range(arch["transformer_layers"]):
        x = resblock(P, x, w, f"transformer.resblocks.{i}",
                     arch["transformer_heads"], causal=True)
    x = x.permute(1, 0, 2)
    eot = tokens.argmax(dim=-1)
    x = x[torch.arange(x.shape[0], device=x.device), eot]
    return P.matmul(ln(x, w, "ln_final"), w["text_projection"])


# ---------------- DiST's side network ----------------


def temporal_net(P, x, w, p, k):
    """x (B, C, T, H, W)."""
    h = ln(x.permute(0, 2, 3, 4, 1), w, f"{p}.ln").permute(0, 4, 1, 2, 3)
    h = P.conv3d(h, w[f"{p}.temporal_net.c_fc1.weight"],
                 w[f"{p}.temporal_net.c_fc1.bias"], padding=(k // 2, 0, 0))
    h = P.conv3d(qg(h), w[f"{p}.temporal_net.c_fc2.weight"],
                 w[f"{p}.temporal_net.c_fc2.bias"], padding=(0, 1, 1))
    return qg(x + h)


def integration_net(P, x, w, p, k, tt):
    """x (L, B*t, C)."""
    l, bt, c = x.shape
    b = bt // tt
    tx = ln(x, w, f"{p}.ln_temporal").view(l, b, tt, c).permute(
        1, 3, 2, 0).reshape(b, c, tt, l, 1)
    tx = P.conv3d(tx, w[f"{p}.temporal_ffn.c_fc1.weight"],
                  w[f"{p}.temporal_ffn.c_fc1.bias"])
    tx = P.conv3d(tx, w[f"{p}.temporal_ffn.c_fc2.weight"],
                  w[f"{p}.temporal_ffn.c_fc2.bias"], padding=(k // 2, 0, 0))
    tx = P.conv3d(qg(tx), w[f"{p}.temporal_ffn.c_proj.weight"],
                  w[f"{p}.temporal_ffn.c_proj.bias"])
    tx = tx.flatten(3).permute(3, 0, 2, 1).flatten(1, 2)
    return mlp(P, ln(x, w, f"{p}.ln"), w, f"{p}.ffn") + tx


def temporal_to_integration(P, x, w, p, alpha):
    """(B, C, T, H, W) -> (1 + HW, B*t, C')."""
    x = P.conv3d(x, w[f"{p}.linear_fuse.weight"], w[f"{p}.linear_fuse.bias"],
                 stride=(alpha, 1, 1)).flatten(3)
    b, c, tt, _ = x.shape
    x = x.permute(3, 0, 2, 1)
    cls = w[f"{p}.cls_token"].expand(1, b, tt, c)
    return torch.cat([cls, x], dim=0).flatten(1, 2)


def integration_to_temporal(P, x, w, p, tt, alpha):
    """(L, B*t, C) -> (B, C', T, H, W)."""
    h = P.linear(x[1:], w[f"{p}.linear_fuse.weight"],
                 w[f"{p}.linear_fuse.bias"])
    l, bt, c = h.shape
    b = bt // tt
    g = int(math.isqrt(l))
    h = h.view(l, b, tt, c).permute(1, 3, 2, 0).reshape(b, c, tt, g, g)
    return F.interpolate(h, size=(tt * alpha, g, g), mode="nearest")


def ada_pool(P, feat, top_cls, spat_cls, w, p, heads, tt):
    """feat (L, B*t, C); top_cls (1, B, C); spat_cls (1, B*t, C)."""
    bt, c = feat.shape[1], feat.shape[2]
    b = bt // tt
    q = ln(spat_cls, w, f"{p}.spatial_transformer.ln_1")
    kv = ln(feat, w, f"{p}.spatial_transformer.ln_1")
    spat_cls = spat_cls + mha(P, q, kv, w, f"{p}.spatial_transformer", heads)
    spat_cls = spat_cls + mlp(P, ln(spat_cls, w, f"{p}.ln_out_spat_cls_token"),
                              w, f"{p}.output_map_spatial_cls_token")
    cls_tok = spat_cls[0].reshape(b, tt, c) + w[f"{p}.positional_embedding"]
    cls_tok = cls_tok.permute(1, 0, 2)
    q = ln(top_cls, w, f"{p}.temporal_transformer.ln_1")
    kv = ln(cls_tok, w, f"{p}.temporal_transformer.ln_1")
    top_cls = top_cls + mha(P, q, kv, w, f"{p}.temporal_transformer", heads)
    top_cls = top_cls + mlp(P, ln(top_cls, w, f"{p}.ln_out_temp_cls_token"),
                            w, f"{p}.output_map_cls_token")
    return top_cls, spat_cls


def dist_network(P, video, taps, w, d, width):
    """video (B, 3, T, H, W) normalised; taps: per selected layer
    (L, B*t, width). Returns (B, E)."""
    nf, alpha, k = d["num_frames"], d["alpha"], d["temporal_kernel_size"]
    tt = nf // alpha
    c = d["integration_dim"]
    x_t = P.conv3d(video, w["dist_net.temporal_stem.weight"],
                   w["dist_net.temporal_stem.bias"],
                   stride=(1, d["s_patch_size"], d["s_patch_size"]),
                   padding=(d["t_patch_size"] // 2, 0, 0))
    res = 0.0
    for i in range(len(d["selected_layers"])):
        x_t = temporal_net(P, x_t, w, f"dist_net.temporal_nets.{i}", k)
        mid = P.linear(taps[i], w[f"dist_net.input_linears.{i}.weight"],
                       w[f"dist_net.input_linears.{i}.bias"]) + res
        upd_t = integration_to_temporal(
            P, mid, w, f"dist_net.integration2temporal_nets.{i}", tt,
            alpha) + x_t
        upd_mid = mid + temporal_to_integration(
            P, x_t, w, f"dist_net.temporal2integration_nets.{i}", alpha)
        res = integration_net(P, upd_mid, w, f"dist_net.integration_nets.{i}",
                              k, tt)
        x_t = upd_t
    bt = upd_mid.shape[1]
    b = bt // tt
    cur = res + upd_mid
    top = w["dist_net.aggregated_cls_token"].expand(1, b, c)
    spat = w["dist_net.aggregated_spatial_cls_token"].expand(1, bt, c)
    for i in range(d["ada_pooling_layers"]):
        top, spat = ada_pool(P, cur, top, spat, w,
                             f"dist_net.adapooling_nets.{i}", c // 64, tt)
    last_cls = taps[-1][0].reshape(b, tt, width).mean(dim=1)
    proj_sp = P.linear(last_cls, w["dist_net.proj_spatial_cls_token.weight"],
                       w["dist_net.proj_spatial_cls_token.bias"])
    x = ln(top[0] + proj_sp, w, "dist_net.ln_post")
    return P.matmul(x, w["dist_net.proj"])


# ---------------- the classifiers ----------------


def _normalize(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-6)


def normalize_video(video_u8, mean, std):
    """uint8 (B, T, H, W, 3) -> normalised float32, same layout."""
    m = torch.tensor(mean, device=video_u8.device) * 255.0
    s = torch.tensor(std, device=video_u8.device) * 255.0
    return (video_u8.float() - m) / s


def video_embedding(P, video, w, spec):
    """Normalised video (B, T, H, W, 3) -> (B, E): CLIP's tower over the
    kept frames, then DiST's side network, or the mean over frames."""
    arch, alpha = spec["arch"], spec["alpha"]
    b, t = video.shape[:2]
    kept = video[:, ::alpha]
    frames = kept.reshape((-1,) + tuple(kept.shape[2:])).permute(0, 3, 1, 2)
    dist = spec.get("dist")
    frozen = spec["frozen_tower"]
    with torch.set_grad_enabled(torch.is_grad_enabled() and not frozen):
        emb, taps = visual_tower(P, frames, w, arch, dist is not None)
    if dist is None:
        return emb.reshape(b, t // alpha, -1).mean(dim=1)
    taps = [taps[i] for i in dist["selected_layers"]]
    return dist_network(P, video.permute(0, 4, 1, 2, 3), taps, w, dist,
                        arch["vision_width"])


def logits(P, video, w, spec, text_features=None, dropout=None):
    """Class logits (B, classes): the cosine classifier against
    ``text_features`` scaled by exp(logit_scale), or the linear head over
    the embedding (with ``dropout``, a mask already scaled by 1/(1-p))."""
    emb = video_embedding(P, video, w, spec)
    if spec["head"] == "text":
        v, tf = _normalize(emb), _normalize(text_features)
        return torch.exp(w["logit_scale"]) * P.matmul(v, tf.T)
    if dropout is not None:
        emb = emb * dropout
    return P.linear(emb, w["head.out.weight"], w["head.out.bias"])
