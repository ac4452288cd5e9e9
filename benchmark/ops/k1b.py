"""K1b, K1's backward, where the CLIP tower trains: the backward node of
``_AttentionQKV`` (recomputes the attention from (B, L, 3D) and the
output's gradient, writes the gradient of q, k, v), once per block and
step."""

RANGES = ("_AttentionQKVBackward",)


def calls(run):
    from benchmark.ops import k1

    if run.kind != "train" or run.spec["frozen_tower"]:
        return []
    layers = run.spec["arch"]["vision_layers"]
    return [(layers, k1.shape_of(run.spec, n)) for n in run.trace.batches]


def work(shape):
    """(bytes, operations): q, k, v and the output's gradient read once,
    the gradient of q, k, v written once, in bf16; the forward's two
    products again and three gradient products: 10 per (query, key) pair
    and head channel."""
    b, l, d3, heads = shape
    d = d3 // 3
    return 2 * (2 * b * l * d3 + b * l * d), 10 * b * heads * (d // heads) * l * l
