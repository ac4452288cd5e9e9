"""K1, the fused multi-head attention forward of the CLIP tower's blocks:
the operator ``dist_tpu_torch::attention_qkv`` on (B, L, 3D) bf16.
Each block of the vision tower calls it once, on the kept frames of
every clip of a step or of a served (padded) batch."""

RANGES = ("dist_tpu_torch::attention_qkv",)


def shape_of(spec, clips):
    a = spec["arch"]
    tokens = (a["image_resolution"] // a["vision_patch_size"]) ** 2 + 1
    kept = spec["num_frames"] // spec["alpha"]
    return (clips * kept, tokens, 3 * a["vision_width"], a["vision_heads"])


def calls(run):
    """[(calls, shape)] of the traced stretch: the vision tower's blocks
    once per step or batch."""
    layers = run.spec["arch"]["vision_layers"]
    return [(layers, shape_of(run.spec, n)) for n in run.trace.batches]


def work(shape):
    """(bytes, operations): q, k, v read once and the output written
    once, in bf16; q k^T and p v over every (query, key) pair."""
    b, l, d3, heads = shape
    d = d3 // 3
    return 2 * (b * l * d3 + b * l * d), 4 * b * heads * (d // heads) * l * l
