"""The BMN temporal-action-localization head (port of
``dist_tpu/models/heads/bmn.py``).

Outputs, from snippet features ``(B, C, T)``:

    start (B, T), end (B, T)          boundary probabilities (TEM)
    confidence_map (B, 2, D, T)       [regression, classification]
                                      confidence of each (duration,
                                      start) proposal (PEM)
    verb_map (B, n_verb, D, T),       per-proposal class scores, when
    noun_map (B, n_noun, D, T)        ``NUM_CLASSES`` is a pair

The boundary-matching feature is the mean of the snippet features over
each proposal's window, from one cumulative sum, as the JAX package
computes it (not BMN's sampling-mask product); a window that runs past
the end is zero. The PEM runs ``pem_fc1`` (over channels) -> relu ->
``pem_conv`` (3 x 3 over (D, T)) -> relu -> ``pem_fc2`` in the layout
``(B, C, D, T)``. Module names are the JAX package's, so that
``models/backbones/convert.py`` carries the JAX ``head`` collection
across."""

import torch
import torch.nn as nn
import torch.nn.functional as F

from dist_tpu_torch.models.base.models import HEAD_REGISTRY
from dist_tpu_torch.models.precision import island_dtype


def proposal_window_means(x, dscale):
    """x ``(B, C, T)`` -> ``(B, C, D, T)``: the mean of ``x[..., t : t +
    d + 1]`` at ``(d, t)``, zero where the window runs past the end."""
    t = x.shape[-1]
    cs = torch.cat([x.new_zeros(x.shape[:-1] + (1,)), torch.cumsum(x, -1)],
                   dim=-1)
    width = torch.arange(1, dscale + 1, device=x.device)[:, None]
    start = torch.arange(t, device=x.device)[None, :]
    end = torch.clamp(start + width, max=t)                  # (D, T)
    means = (cs[..., end] - cs[..., :t][..., None, :]) / width.to(x.dtype)
    valid = (start + width <= t).to(x.dtype)
    return means * valid


def _linear(x, layer):
    """``layer`` over the channel axis of ``(B, C, D, T)``."""
    w, b = layer.weight.to(x.dtype), layer.bias.to(x.dtype)
    return torch.einsum("bcdt,oc->bodt", x, w) + b[:, None, None]


@HEAD_REGISTRY.register()
class BMNHead(nn.Module):
    """TEM boundary branches and the PEM proposal-confidence branch over
    ``dim_in`` channels; ``forward(x) -> (preds, x)``."""

    def __init__(self, cfg, dim_in):
        super().__init__()
        hidden = int(cfg.VIDEO.get("DIM1D", dim_in))
        self.dscale = int(cfg.LOCALIZATION.DSCALE)
        for name in ("start", "end"):
            setattr(self, f"{name}_conv1",
                    nn.Conv1d(dim_in, hidden, 3, padding=1))
            setattr(self, f"{name}_conv2", nn.Conv1d(hidden, 1, 1))
        self.pem_fc1 = nn.Linear(dim_in, hidden)
        self.pem_conv = nn.Conv2d(hidden, hidden, 3, padding=1)
        self.pem_fc2 = nn.Linear(hidden, 2)
        self.maps = ()
        nc = cfg.VIDEO.HEAD.get("NUM_CLASSES")
        if isinstance(nc, (list, tuple)) and len(nc) == 2:
            self.maps = ("verb", "noun")
            self.verb_map_fc = nn.Linear(hidden, int(nc[0]))
            self.noun_map_fc = nn.Linear(hidden, int(nc[1]))

    def _tem(self, x, name):
        c1 = getattr(self, f"{name}_conv1")
        c2 = getattr(self, f"{name}_conv2")
        h = F.relu(F.conv1d(x, c1.weight.to(x.dtype), c1.bias.to(x.dtype),
                            padding=1))
        h = F.conv1d(h, c2.weight.to(x.dtype), c2.bias.to(x.dtype))
        return torch.sigmoid(h[:, 0].to(island_dtype(h)))

    def forward(self, x):
        if isinstance(x, dict):
            x = x.get("features", x)
        preds = {"start": self._tem(x, "start"), "end": self._tem(x, "end")}
        pem = proposal_window_means(x, self.dscale)          # (B, C, D, T)
        h = F.relu(_linear(pem, self.pem_fc1))
        h = F.relu(F.conv2d(h, self.pem_conv.weight.to(h.dtype),
                            self.pem_conv.bias.to(h.dtype), padding=1))
        conf = _linear(h, self.pem_fc2)                      # (B, 2, D, T)
        preds["confidence_map"] = torch.sigmoid(conf.to(island_dtype(conf)))
        for name in self.maps:
            logits = _linear(h, getattr(self, f"{name}_map_fc"))
            preds[f"{name}_map"] = torch.softmax(
                logits.to(island_dtype(logits)), dim=1)
        return preds, x
