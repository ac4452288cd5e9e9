"""CLIP vision and text towers (port of ``dist_tpu/models/clip/model.py``).

Parameter names and layouts are those of the reference's torch CLIP, so a
released state dict loads as it is: ``visual.conv1.weight`` (O, 3, p, p),
``visual.transformer.resblocks.<i>.*``, and the text tower's weights at
the root (``token_embedding``, ``positional_embedding``,
``transformer.resblocks.<i>.*``, ``ln_final``, ``text_projection``). The
JAX package's ``nn.scan`` over stacked layers (and its pipeline path)
becomes a plain loop over an ``nn.ModuleList``; its ``nn.remat`` of the
scan body (``TPU.REMAT``) becomes ``torch.utils.checkpoint`` of each
block of a tower that keeps a graph for a backward.
"""

import dataclasses

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from dist_tpu_torch.models.base.blocks import (
    Conv2d,
    LayerNorm,
    ResidualAttentionBlock,
)


@dataclasses.dataclass(frozen=True)
class CLIPArchitecture:
    """Shape-derived CLIP hyperparameters."""

    embed_dim: int
    image_resolution: int
    vision_layers: int
    vision_width: int
    vision_patch_size: int
    context_length: int
    vocab_size: int
    transformer_width: int
    transformer_heads: int
    transformer_layers: int

    @property
    def vision_heads(self):
        return self.vision_width // 64

    @property
    def grid_size(self):
        return self.image_resolution // self.vision_patch_size


def sniff_architecture(state_dict) -> CLIPArchitecture:
    """The architecture from a torch-named state dict's shapes."""
    if "visual.proj" not in state_dict:
        raise ValueError("only ViT CLIP variants are supported (the DiST "
                         "projects never use the ResNet CLIP tower)")
    vision_width = state_dict["visual.conv1.weight"].shape[0]
    vision_layers = len([
        k for k in state_dict
        if k.startswith("visual.") and k.endswith(".attn.in_proj_weight")])
    vision_patch_size = state_dict["visual.conv1.weight"].shape[-1]
    grid_size = round(
        (state_dict["visual.positional_embedding"].shape[0] - 1) ** 0.5)
    transformer_width = state_dict["ln_final.weight"].shape[0]
    return CLIPArchitecture(
        embed_dim=state_dict["text_projection"].shape[1],
        image_resolution=vision_patch_size * grid_size,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=vision_patch_size,
        context_length=state_dict["positional_embedding"].shape[0],
        vocab_size=state_dict["token_embedding.weight"].shape[0],
        transformer_width=transformer_width,
        transformer_heads=transformer_width // 64,
        transformer_layers=len(set(
            k.split(".")[2] for k in state_dict
            if k.startswith("transformer.resblocks"))),
    )


# well-known architectures, so models can be built without a checkpoint
ARCHITECTURES = {
    "ViT-B-32": CLIPArchitecture(512, 224, 12, 768, 32, 77, 49408, 512, 8, 12),
    "ViT-B-16": CLIPArchitecture(512, 224, 12, 768, 16, 77, 49408, 512, 8, 12),
    "ViT-L-14": CLIPArchitecture(768, 224, 24, 1024, 14, 77, 49408, 768, 12, 12),
    # tiny architecture for smoke tests / CPU pipelines
    "ViT-Test": CLIPArchitecture(32, 64, 2, 64, 16, 77, 49408, 64, 1, 2),
}


class Transformer(nn.Module):
    """A stack of residual attention blocks. With ``remat``, each block
    that runs with a gradient is recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant), which keeps only the
    blocks' inputs alive for it; under ``no_grad`` it changes nothing.

    ``pipe_stages > 1`` (``TPU.MESH.PIPE``, the vision tower's): the same
    blocks run through the GPipe schedule of ``parallel/pipeline.py`` over
    the pipe group that ``parallel/pipeline.py::check_model`` gives the
    tower as ``pipe``, with ``pipe_microbatches`` microbatches
    (``TPU.PIPE_MICROBATCHES``, 0: one per stage); without that group it
    raises, as the JAX package asserts its mesh. There a rank holds only
    its stage's blocks (the others are ``parallel/pipeline.py::
    HeldElsewhere``), with or without remat; the checkpoints hold every
    block either way (``parallel/shards.py``)."""

    # the stacked blocks the JAX package scans over
    jax_scanned = ("resblocks",)

    def __init__(self, width, layers, heads, causal=False, remat=False,
                 pipe_stages=1, pipe_microbatches=0):
        super().__init__()
        self.remat = remat
        self.pipe_stages = int(pipe_stages)
        self.pipe_microbatches = int(pipe_microbatches)
        self.pipe = None
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, causal=causal)
            for _ in range(layers))

    def forward(self, x, collect_taps=False):
        """-> (final x, per-layer outputs (layers, B, L, D) or None). Each
        layer's output is written into one buffer as it comes, as the JAX
        scan's ``ys`` is, so the taps are held once (ViT-L/14 at 1,024
        frames: 12.9 GB in bf16), not in a list and again in its stack.
        Under autograd the writes are recorded (``CopySlices``), so a
        gradient through the taps reaches each block."""
        taps = None
        remat = self.remat and torch.is_grad_enabled()
        if self.pipe_stages > 1:
            return self._pipelined(x, collect_taps, remat)
        for i, block in enumerate(self.resblocks):
            x = (checkpoint(block, x, use_reentrant=False) if remat
                 else block(x))
            if collect_taps:
                if taps is None:
                    taps = x.new_empty((len(self.resblocks),) + x.shape)
                taps[i] = x
        return x, taps

    def _pipelined(self, x, collect_taps, remat):
        from dist_tpu_torch.parallel.pipeline import pipeline_stack

        pipe = self.pipe
        if pipe is None or pipe["stages"] != self.pipe_stages:
            raise ValueError(
                f"TPU.MESH.PIPE={self.pipe_stages} needs a process group "
                f"whose pipe axis is {self.pipe_stages} (python -m "
                "dist_tpu_torch.run starts one); got "
                f"{None if pipe is None else pipe['stages']}")

        def run(block, c):
            return (checkpoint(block, c, use_reentrant=False) if remat
                    else block(c))

        return pipeline_stack(self.resblocks, x, group=pipe["group"],
                              stage=pipe["stage"], stages=pipe["stages"],
                              n_microbatches=self.pipe_microbatches,
                              collect_taps=collect_taps, run_layer=run)


class VisionTransformer(nn.Module):
    """CLIP ViT over batched video frames.

    Input: normalised frames (B, T, H, W, 3) in the compute dtype. Keeps
    every ``sparse_alpha``-th frame. The JAX package patchifies all T
    frames and slices after ``ln_pre``; every step before the slice acts
    on each frame alone, so slicing first gives the same values for half
    the patchify work.

    Returns (cls_x (B*t, embed_dim), x_logits (B*t, width),
    taps (layers, B*t, L, width) or None).
    """

    def __init__(self, arch, sparse_alpha=1, remat=False, pipe_stages=1,
                 pipe_microbatches=0):
        super().__init__()
        w, p = arch.vision_width, arch.vision_patch_size
        self.arch = arch
        self.sparse_alpha = sparse_alpha
        self.conv1 = Conv2d(3, w, p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(
            torch.empty(arch.grid_size ** 2 + 1, w))
        self.ln_pre = LayerNorm(w)
        self.transformer = Transformer(w, arch.vision_layers,
                                       arch.vision_heads, remat=remat,
                                       pipe_stages=pipe_stages,
                                       pipe_microbatches=pipe_microbatches)
        self.ln_post = LayerNorm(w)
        self.proj = nn.Parameter(torch.empty(w, arch.embed_dim))

    def init_own(self, generator):
        std = self.arch.vision_width ** -0.5
        for p in (self.class_embedding, self.positional_embedding, self.proj):
            p.normal_(0.0, std, generator=generator)

    def forward(self, frames, collect_taps=True, sampled=False):
        """``sampled``: ``frames`` are the kept frames already (the
        frame-parallel eval hands each device its share of them)."""
        if self.sparse_alpha > 1 and not sampled:
            frames = frames[:, ::self.sparse_alpha]
        x = frames.reshape((-1,) + tuple(frames.shape[2:])).permute(0, 3, 1, 2)
        x = self.conv1(x)                              # (B*t, width, g, g)
        x = x.flatten(2).transpose(1, 2)               # (B*t, g*g, width)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        x = self.ln_pre(x)
        x, taps = self.transformer(x, collect_taps)
        x_logits = self.ln_post(x[:, 0, :])
        return x_logits @ self.proj.to(x_logits.dtype), x_logits, taps


class TextTransformer(nn.Module):
    """CLIP text tower, causal; input int tokens (N, context_length).

    Its parameters sit at the root of the reference's CLIP state dict, so
    the full model (``CLIPDiSTModel``) derives from this class rather than
    holding it as a child.
    """

    def __init__(self, arch, remat=False):
        super().__init__()
        self.arch = arch
        self.token_embedding = nn.Embedding(arch.vocab_size,
                                            arch.transformer_width)
        self.positional_embedding = nn.Parameter(
            torch.empty(arch.context_length, arch.transformer_width))
        self.transformer = Transformer(arch.transformer_width,
                                       arch.transformer_layers,
                                       arch.transformer_heads, causal=True,
                                       remat=remat)
        self.ln_final = LayerNorm(arch.transformer_width)
        self.text_projection = nn.Parameter(
            torch.empty(arch.transformer_width, arch.embed_dim))

    def init_own(self, generator):
        self.positional_embedding.normal_(0.0, 0.01, generator=generator)
        self.text_projection.normal_(
            0.0, self.arch.transformer_width ** -0.5, generator=generator)

    def forward(self, text, dtype=torch.float32):
        """-> (features (N, embed_dim), eot activations (N, width))."""
        x = self.token_embedding(text).to(dtype)
        x = x + self.positional_embedding.to(dtype)
        x, _ = self.transformer(x)
        # eot token = highest token id in each sequence
        eot = text.argmax(dim=-1)
        x_logits = x[torch.arange(x.shape[0], device=x.device), eot]
        x = self.ln_final(x_logits)
        return x @ self.text_projection.to(x.dtype), x_logits
