"""Ahead-of-time model export (port of ``dist_tpu/serving/export.py``).

The serving engine's fixed-shape predictor is traced with
``torch.export`` into one program and saved with ``torch.export.save``.
Weights, the label-text features and the head's eval activation are
baked in: the program maps uint8 ``(B, T, S, S, 3)`` clips to float32
``(B, classes)`` scores, and no text-tower kernel runs per call.

- **The same function.** The predictor is the serving engine's
  (``tasks/state.py::make_eval_step``: uint8 normalisation on the device
  -> backbone -> head eval activation), traced as an ``nn.Module``, so the
  program's scores equal the engine's on the same device.
- **Kernels by name.** The hand-written kernels on the eval path, K1
  (``dist_tpu_torch::attention_qkv``) and K2
  (``dist_tpu_torch::temporal_net_fwd``), are ``torch.library`` operators
  with a CUDA kernel and a CPU kernel (their plain versions). The program
  calls them by name; K2's packed fp32 weights are constants of the
  program (``TemporalNet.freeze_packed``), so a call never repacks them.
- **One artifact, two devices.** The same file runs on the CPU and on the
  card, as the JAX package's ``platforms=("cpu", "tpu")``:
  :func:`load_predictor` moves the program to the device it is asked for.
- **Fixed shapes.** The program takes the export-time batch, frames and
  crop; the loader pads a smaller request with zero clips.

What the loader needs: ``torch`` and ``dist_tpu_torch.ops`` (importing it
registers the two operators; a saved program cannot run without them).
:func:`load_predictor` imports nothing else of the framework: no model
code, no config, no task, no checkpoint loader.
"""

import json
import os

import numpy as np
import torch

import dist_tpu_torch.ops  # noqa: F401  (registers K1's and K2's operators)
from dist_tpu_torch.utils.device import resolve_device
from dist_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

META_SUFFIX = ".json"
PLATFORMS = ("cpu", "cuda")


class Predictor(torch.nn.Module):
    """The serving engine's eval step as a module: uint8 clips -> float32
    scores, with the engine's weights and label-text features (a buffer)
    inside."""

    def __init__(self, engine):
        from dist_tpu_torch.tasks.state import make_eval_step

        super().__init__()
        self.module = engine.model.module
        if isinstance(engine.model.head, torch.nn.Module):
            self.head = engine.model.head
        text = engine.text_features
        if text is not None:
            self.register_buffer("text_features", text)
        else:
            self.text_features = None
        self._step = make_eval_step(engine.model, engine.cfg)

    def forward(self, video_u8):
        batch = {"video": video_u8, "text_features": self.text_features}
        return self._step(batch)["preds"].float()


def _prune(program):
    """Trim what every call of the traced program would carry for
    nothing, in place: the ``aten._assert_tensor_metadata`` checks that
    tracing puts before each ``.to()`` (hundreds in the flagship, host time
    on every call; the program's one input is checked where it enters, and
    every ``.to()`` after it sees the types and devices tracing saw), and
    the inputs no node reads, with their tensors: ``torch.export`` lifts
    every parameter and buffer of the module, the text tower's too, whose
    features are baked in."""
    graph = program.graph_module.graph
    for node in list(graph.nodes):
        if node.op == "call_function" and node.target == \
                torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
    user = set(program.graph_signature.user_inputs)
    unused = {n.name for n in graph.nodes if n.op == "placeholder"
              and not n.users and n.name not in user}
    specs = program.graph_signature.input_specs
    for spec in [sp for sp in specs if sp.arg.name in unused]:
        specs.remove(spec)
        program.state_dict.pop(spec.target, None)
        program.constants.pop(spec.target, None)
    for node in list(graph.nodes):
        if node.name in unused:
            graph.erase_node(node)
    program.graph_module.recompile()


def export_engine(engine):
    """Trace ``engine``'s predictor at its batch size with
    ``torch.export`` on the engine's device -> ``(ExportedProgram,
    meta)``. Freezes the packed weights of every fused TemporalNet in the
    engine's model (:meth:`TemporalNet.freeze_packed`) and drops what no
    call needs (:func:`_prune`)."""
    from dist_tpu_torch.models.dist.dist_net import TemporalNet

    for m in engine.model.module.modules():
        if isinstance(m, TemporalNet) and m.fused:
            m.freeze_packed()
    predictor = Predictor(engine).eval()
    spec = torch.zeros((engine.batch_size, engine.num_frames, engine.crop,
                        engine.crop, 3), dtype=torch.uint8,
                       device=engine.device)
    with torch.no_grad():
        program = torch.export.export(predictor, (spec,))
    _prune(program)
    meta = {
        "batch_size": engine.batch_size,
        "num_frames": engine.num_frames,
        "crop": engine.crop,
        "num_classes": engine.num_classes,
        "label_names": engine.label_names,
        "platforms": list(PLATFORMS),
        "input": "uint8 (B, T, S, S, 3)",
        "output": f"float32 (B, {engine.num_classes}) class scores",
        "exported_on": engine.device.type,
        "torch": torch.__version__,
    }
    return program, meta


def export_predictor(cfg, batch_size=8, device=None):
    """Build the serving engine for ``cfg`` (checkpoint resolution and
    label-text setup as the engine and the test task do) on ``device``
    (the card unless ``"cpu"``) and export its predictor. Returns
    ``(ExportedProgram, meta)``.

    The program is one single-device function, so ``TPU.MESH.PIPE`` and
    ``MODEL`` are forced to 1 and ``TPU.FSDP`` off, on a copy of ``cfg``:
    the sequential, replicated configuration is the same function with the
    same weights (as the JAX package forces,
    ``dist_tpu/serving/export.py:45-56``)."""
    from dist_tpu_torch.serving.engine import InferenceEngine

    mesh = cfg.TPU.get("MESH") or {}
    if (int(mesh.get("PIPE", 1) or 1) > 1 or int(mesh.get("MODEL", 1) or 1) > 1
            or bool(cfg.TPU.get("FSDP", False))):
        cfg = cfg.deep_copy()
        cfg.TPU.MESH.PIPE = 1
        cfg.TPU.MESH.MODEL = 1
        cfg.TPU.FSDP = False
    engine = InferenceEngine(cfg, batch_size=batch_size, device=device)
    return export_engine(engine)


def save_exported(path, program, meta):
    """Write ``<path>`` (``torch.export.save`` of the program) and the
    ``<path>.json`` sidecar."""
    torch.export.save(program, path)
    with open(path + META_SUFFIX, "w") as f:
        json.dump(meta, f, indent=1)
    logger.info("Exported %s (%.1f MiB) + %s", path,
                os.path.getsize(path) / 2**20, path + META_SUFFIX)


def _input_shape(program):
    user = set(program.graph_signature.user_inputs)
    for node in program.graph.nodes:
        if node.op == "placeholder" and node.name in user:
            return tuple(node.meta["val"].shape)
    raise ValueError("the exported program takes no input")


def load_predictor(path, device=None):
    """Load an exported artifact -> ``(predict, meta)``.

    ``predict(clips)`` takes uint8 ``(n <= B, T, S, S, 3)`` (numpy or a
    tensor; padded to the exported batch with zero clips) and returns
    ``(n, num_classes)`` float32 scores as numpy. The program runs on the
    CUDA card unless ``device="cpu"`` is passed; without a card and
    without that, this raises. ``meta`` is the sidecar's dict ({} without
    one). Needs only ``torch`` and ``dist_tpu_torch.ops``."""
    device = resolve_device(device)
    from torch.export.passes import move_to_device_pass

    program = move_to_device_pass(torch.export.load(path), str(device))
    meta = {}
    if os.path.exists(path + META_SUFFIX):
        with open(path + META_SUFFIX) as f:
            meta = json.load(f)
    shape = _input_shape(program)
    call = program.module()

    def predict(clips):
        clips = torch.as_tensor(np.asarray(clips))
        if clips.dtype != torch.uint8 or tuple(clips.shape[1:]) != shape[1:]:
            raise ValueError(f"expected uint8 (n, {', '.join(map(str, shape[1:]))})"
                             f", got {clips.dtype} {tuple(clips.shape)}")
        n = clips.shape[0]
        if not 0 < n <= shape[0]:
            raise ValueError(f"{n} clips for an exported batch of {shape[0]}")
        if n < shape[0]:
            clips = torch.cat([clips, clips.new_zeros((shape[0] - n,)
                                                      + shape[1:])])
        with torch.no_grad():
            return call(clips.to(device))[:n].cpu().numpy()

    return predict, meta
