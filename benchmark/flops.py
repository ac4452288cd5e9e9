"""The model's operations, counted from the configuration's shapes (a
multiply-add is 2): the numerator of ``train_mfu`` and ``serve_mfu``.

Only products are counted (linear layers, convolutions, the attention's
two products); norms, activations and softmax are left out. A part that
trains counts its forward three times (forward, and a backward of twice
the forward); a frozen part once; recomputation is not counted. The
label texts are encoded once at set-up and are no step's work."""


def frame_flops(arch):
    """One frame through the ViT's blocks: per block the q, k, v
    projection 6 T d^2, the out-projection 2 T d^2, the MLP 16 T d^2 and
    attention 4 T^2 d, with T tokens of width d."""
    t = (arch["image_resolution"] // arch["vision_patch_size"]) ** 2 + 1
    d = arch["vision_width"]
    return arch["vision_layers"] * (24 * t * d * d + 4 * t * t * d)


def tower_frame_flops(arch):
    """One kept frame through CLIP's vision tower: the patch projection,
    the blocks and the class token's projection."""
    p, d = arch["vision_patch_size"], arch["vision_width"]
    patches = (arch["image_resolution"] // p) ** 2
    return (2 * patches * 3 * p * p * d + frame_flops(arch)
            + 2 * d * arch["embed_dim"])


def side_network_flops(spec):
    """One clip through DiST's side network (its forward)."""
    a, d = spec["arch"], spec["dist"]
    width, e = a["vision_width"], a["embed_dim"]
    nf, alpha, k = d["num_frames"], d["alpha"], d["temporal_kernel_size"]
    tt = nf // alpha
    c, ct = d["integration_dim"], d["temporal_dim"]
    h_t = int(ct * d["temporal_conv_mlp_ratio"])
    h_i = int(c * d["integration_mlp_ratio"])
    h_it = int(c * d["integration_temporal_mlp_ratio"])
    g = a["image_resolution"] // d["s_patch_size"]
    hw = g * g
    tokens = hw + 1
    stem = 2 * nf * hw * ct * 3 * d["t_patch_size"] * d["s_patch_size"] ** 2
    step = (
        2 * nf * hw * (ct * h_t * k + h_t * ct * 9)       # temporal net
        + 2 * tt * tokens * width * c                     # input linear
        + 2 * tt * hw * c * ct                            # integration -> temporal
        + 2 * tt * hw * ct * alpha * c                    # temporal -> integration
        + 2 * tt * tokens * 2 * c * h_i                   # integration MLP
        + 2 * tt * tokens * (c * h_it + h_it * h_it * k + h_it * c))
    pool = (
        # spatial: one query a frame over its tokens, the MLP on the query
        tt * (2 * c * c + 2 * tokens * 2 * c * c + 4 * tokens * c
              + 2 * c * c + 16 * c * c)
        # temporal: one query a clip over its frames' queries
        + 2 * c * c + 2 * tt * 2 * c * c + 4 * tt * c + 2 * c * c
        + 16 * c * c)
    tail = 2 * width * c + 2 * c * e
    return (stem + len(d["selected_layers"]) * step
            + d["ada_pooling_layers"] * pool + tail)


def head_flops(spec):
    """One clip through the classifier: the cosine against the label
    features, or the linear head."""
    return 2 * spec["arch"]["embed_dim"] * spec["classes"]


def clip_flops(spec, train):
    """Operations for one clip: of a training step (``train``) or of a
    served request."""
    kept = spec["num_frames"] // spec["alpha"]
    tower = kept * tower_frame_flops(spec["arch"])
    side = side_network_flops(spec) if spec.get("dist") else 0
    head = head_flops(spec)
    if not train:
        return tower + side + head
    return (tower * (1 if spec["frozen_tower"] else 3) + 3 * side + 3 * head)
