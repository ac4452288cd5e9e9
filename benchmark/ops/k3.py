"""K3, the TemporalNet block's backward (recomputes the forward, writes
the input's gradient and the seven weight gradients): the backward node
of ``_TemporalNetFunction``, once per ladder step of a training step."""

RANGES = ("_TemporalNetFunctionBackward",)


def calls(run):
    from benchmark.ops import k2

    d = run.spec.get("dist")
    if run.kind != "train" or not d:
        return []
    steps = len(d["selected_layers"])
    return [(steps, k2.shape_of(run.spec, n)) for n in run.trace.batches]


def work(shape):
    """(bytes, operations): x, the output's gradient and the input's
    gradient once each in bf16, the weights read and their gradients
    written in fp32; the forward again and two gradient products per
    tap, 6 N C F (k + 9)."""
    from benchmark.ops import k2

    b, t, h, w, c, f, k = shape
    n = b * t * h * w
    return 3 * 2 * n * c + 2 * k2.param_bytes(c, f, k), 6 * n * c * f * (k + 9)
