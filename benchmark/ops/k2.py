"""K2, DiST's fused TemporalNet block (LayerNorm, the temporal conv, quick
GELU, the 3x3 spatial conv, the residual): the operator
``dist_tpu_torch::temporal_net_fwd`` on the dense stream (B, T, H, W, C)
bf16, once per ladder step of every step or served (padded) batch."""

RANGES = ("dist_tpu_torch::temporal_net_fwd",)


def shape_of(spec, clips):
    d = spec["dist"]
    g = spec["arch"]["image_resolution"] // d["s_patch_size"]
    f = int(d["temporal_dim"] * d["temporal_conv_mlp_ratio"])
    return (clips, d["num_frames"], g, g, d["temporal_dim"], f,
            d["temporal_kernel_size"])


def calls(run):
    d = run.spec.get("dist")
    if not d:
        return []
    steps = len(d["selected_layers"])
    return [(steps, shape_of(run.spec, n)) for n in run.trace.batches]


def param_bytes(c, f, k):
    """The block's fp32 weights: LayerNorm, both convs and their biases."""
    return 4 * (k * c * f + 9 * f * c + 3 * c + f)


def work(shape):
    """(bytes, operations): x read and the output written once in bf16,
    the weights once; 2 N C F (k + 9) over N positions."""
    b, t, h, w, c, f, k = shape
    n = b * t * h * w
    return 2 * 2 * n * c + param_bytes(c, f, k), 2 * n * c * f * (k + 9)
