"""Model export (``dist_tpu_torch/serving/export.py``), the twin of
``tests/test_export.py``, and K1 and K2 as ``torch.library`` operators.

The tiny config in fp32 with the fused TemporalNet, so that both
operators are in the program: exported, saved, loaded on the CPU and
called with fewer clips than its batch, it gives the port engine's scores
(1e-6: only the batch the BLAS calls see differs). The same program held
to the JAX engine is ``test_torch_port_engine.py::
test_exported_program_matches_jax``, beside the JAX engine it shares. A
second process loads and runs the file with only the loader's imports.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dist_tpu_torch.config import load_config
from dist_tpu_torch.ops import attention as att
from dist_tpu_torch.ops import temporal_net as tn
from dist_tpu_torch.serving import engine as engine_mod
from dist_tpu_torch.serving import export
from dist_tpu_torch.tools import export_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = "configs/projects/dist/test/tiny_synth.yaml"
OPTS = ["TRAIN.MIXED_PRECISION", "false", "TPU.FUSED_TEMPORAL_NET", "true"]
# what export_predictor must force off on a copy of the config
MESH_OPTS = ["TPU.MESH.PIPE", "2", "TPU.MESH.MODEL", "2", "TPU.FSDP", "true"]
BATCH = 2
ENGINE_LIMIT = 1e-6


def _cfg(*opts):
    return load_config(os.path.join(REPO, CFG), list(OPTS) + list(opts),
                       make_output_dir=False)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """export_predictor on a config with PIPE, MODEL and FSDP set, the
    config each engine was built from, and the saved file."""
    cfg = _cfg(*MESH_OPTS)
    built = []

    class Spy(engine_mod.InferenceEngine):
        def __init__(self, cfg, *args, **kwargs):
            built.append(cfg)
            super().__init__(cfg, *args, **kwargs)

    mp = pytest.MonkeyPatch()
    mp.setattr(engine_mod, "InferenceEngine", Spy)
    try:
        program, meta = export.export_predictor(cfg, batch_size=BATCH,
                                                device="cpu")
    finally:
        mp.undo()
    path = str(tmp_path_factory.mktemp("export") / "model.pt2")
    export.save_exported(path, program, meta)
    return cfg, built, program, meta, path


def test_roundtrip_matches_the_engine(exported):
    _, _, _, meta, path = exported
    assert meta["num_classes"] == 12 and meta["batch_size"] == BATCH
    assert meta["platforms"] == ["cpu", "cuda"]
    assert meta["torch"] == torch.__version__
    assert os.path.exists(path) and os.path.exists(path + ".json")
    predict, meta2 = export.load_predictor(path, device="cpu")
    assert meta2 == json.loads(json.dumps(meta))
    rng = np.random.default_rng(0)
    clip = rng.integers(0, 256, (1, meta["num_frames"], meta["crop"],
                                 meta["crop"], 3), dtype=np.uint8)
    got = predict(clip)                    # n=1 < B=2: padded, sliced back
    assert got.shape == (1, meta["num_classes"]) and got.dtype == np.float32
    engine = engine_mod.InferenceEngine(_cfg(), batch_size=BATCH,
                                        device="cpu")
    want = engine.predict(clip)
    np.testing.assert_allclose(got, want, rtol=0, atol=ENGINE_LIMIT)
    with pytest.raises(ValueError):
        predict(np.zeros((BATCH + 1,) + clip.shape[1:], np.uint8))
    with pytest.raises(ValueError):
        predict(clip.astype(np.float32))


def test_export_forces_the_mesh_off_on_a_copy(exported):
    cfg, built, _, _, _ = exported
    assert len(built) == 1 and built[0] is not cfg
    assert (int(built[0].TPU.MESH.PIPE), int(built[0].TPU.MESH.MODEL),
            bool(built[0].TPU.FSDP)) == (1, 1, False)
    assert (int(cfg.TPU.MESH.PIPE), int(cfg.TPU.MESH.MODEL),
            bool(cfg.TPU.FSDP)) == (2, 2, True)


def test_program_calls_both_operators_on_constant_weights(exported):
    """K1 once per vision layer (never causal: the text features are
    baked in), K2 once per ladder step on the packed weights the program
    holds (placeholders, never recomputed in the graph)."""
    _, _, program, _, _ = exported
    calls = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and "dist_tpu_torch" in str(node.target):
            calls.setdefault(str(node.target), []).append(node)
    attention = calls.pop("dist_tpu_torch.attention_qkv.default")
    fwd = calls.pop("dist_tpu_torch.temporal_net_fwd.default")
    assert calls == {}
    assert not any("_assert_tensor_metadata" in str(n.target)
                   for n in program.graph.nodes)
    assert len(attention) == 2 and len(fwd) == 2
    assert [n.args[2] for n in attention] == [False, False]
    kinds = {s.arg.name: s.kind.name
             for s in program.graph_signature.input_specs}
    for node in fwd:
        assert [kinds.get(a.name) for a in node.args[1:]] == ["BUFFER"] * 6


def test_program_runs_without_the_framework(exported):
    """Deployment side: a fresh process imports only torch and
    ``dist_tpu_torch.ops`` (then the loader's module), runs the file, and
    loads no model code, config or task."""
    _, _, _, meta, path = exported
    shape = (meta["num_frames"], meta["crop"], meta["crop"], 3)
    code = f"""
import json, sys
import torch
import dist_tpu_torch.ops
program = torch.export.load({path!r})
clips = torch.zeros({(BATCH,) + shape}, dtype=torch.uint8)
with torch.no_grad():
    scores = program.module()(clips)
from dist_tpu_torch.serving.export import load_predictor
predict, _ = load_predictor({path!r}, device="cpu")
again = predict(clips[:1].numpy())
loaded = [m for m in ("dist_tpu_torch.models", "dist_tpu_torch.config",
                      "dist_tpu_torch.tasks", "dist_tpu_torch.data")
          if m in sys.modules]
print(json.dumps({{"shape": list(scores.shape),
                  "dtype": str(scores.dtype),
                  "sums": scores.sum(-1).tolist(),
                  "again": again.tolist()[0],
                  "first": scores[0].tolist(), "loaded": loaded}}))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["loaded"] == []
    assert got["shape"] == [BATCH, meta["num_classes"]]
    assert got["dtype"] == "torch.float32"
    # the head's softmax is baked in
    np.testing.assert_allclose(got["sums"], 1.0, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["again"], got["first"], rtol=0, atol=1e-6)


def test_loader_needs_a_card_unless_told(exported, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export.load_predictor(exported[4])


def _attention_case(causal):
    rng = np.random.default_rng(7)
    return (torch.from_numpy(rng.standard_normal((2, 9, 3 * 32)).astype(
        np.float32)), 2, causal)


def _temporal_net_case():
    rng = np.random.default_rng(8)
    c, f, k = 8, 16, 3
    x = torch.from_numpy(rng.standard_normal((2, 4, 3, 5, c)).astype(
        np.float32))
    raw = [rng.standard_normal(s).astype(np.float32) * 0.3 for s in
           ((c,), (c,), (k, 1, 1, c, f), (f,), (1, 3, 3, f, c), (c,))]
    return x, [torch.from_numpy(p) for p in raw]


@pytest.mark.parametrize("causal", [False, True])
def test_attention_operator(causal):
    qkv, heads, causal = _attention_case(causal)
    torch.library.opcheck(att.attention_qkv_op, (qkv, heads, causal))
    before = att.fused_attention_qkv.launches
    got = torch.ops.dist_tpu_torch.attention_qkv(qkv, heads, causal)
    want = att.attention_qkv_plain(qkv, heads, causal)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert att.fused_attention_qkv.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_temporal_net_operator(dtype):
    x, raw = _temporal_net_case()
    x = x.to(dtype)
    packed = tn.pack_weights(*raw)
    torch.library.opcheck(tn.temporal_net_fwd_op, (x, *packed))
    before = tn.fused_temporal_net.launches
    got = torch.ops.dist_tpu_torch.temporal_net_fwd(x, *packed)
    want = tn.temporal_net_plain(x, *raw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tn.fused_temporal_net.launches == before
    with pytest.raises(ValueError, match="pack_weights"):
        tn.temporal_net_fwd_op(x, *raw)            # raw layouts, not packed


def test_tool_needs_a_card_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_model.main(["--cfg", os.path.join(REPO, CFG), "--out",
                           str(tmp_path / "x.pt2")])


def test_tool_exports_and_verifies_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "tool.pt2")
    assert export_model.main(["--cfg", os.path.join(REPO, CFG), "--out", out,
                              "--batch-size", str(BATCH), "--device", "cpu",
                              "--verify", *OPTS]) == 0
    assert "verify OK" in capsys.readouterr().out
    with open(out + ".json") as f:
        assert json.load(f)["exported_on"] == "cpu"
