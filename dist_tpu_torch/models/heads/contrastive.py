"""The contrastive and HiCo heads of SSL pretraining (port of
``dist_tpu/models/heads/contrastive.py``).

Each head pools the backbone's output (a dict's ``features``, a 5-D map
``(B, C, T, H, W)`` its mean over T, H and W) and projects it with
:class:`ProjectionMLP`; the HiCo heads add a topical map, the same-topic
scores of every pair of samples. Module names are the JAX package's, so
that ``models/backbones/convert.py`` carries the JAX ``head`` and
``head_stats`` collections across one to one. The BatchNorm layers are
flax's (``models/base/bn.py``: biased variance, decay 0.99, eps 1e-3) on
``(N, C)``; inside a group of ranks they normalise with the statistics
of every rank's rows.

The topical map mixes samples, so inside a group the topical predictors
take every rank's embeddings (``parallel/collectives.py::
gather_with_grad``) before they pair them: each rank's map is the global
batch's, as the JAX step's is."""

import torch
import torch.nn as nn
import torch.nn.functional as F

from dist_tpu_torch.models.base.bn import BatchNorm
from dist_tpu_torch.models.base.models import HEAD_REGISTRY
from dist_tpu_torch.models.precision import island_dtype
from dist_tpu_torch.parallel.collectives import gather_with_grad

# flax's nn.BatchNorm defaults, with the heads' epsilon
BN_MOMENTUM = 0.99
BN_EPS = 1e-3


def _bn(dim):
    return BatchNorm(dim, momentum=BN_MOMENTUM, eps=BN_EPS)


class ProjectionMLP(nn.Module):
    """``linear_a`` (+ ``linear_a_bn``) -> relu -> ``linear_b`` (+
    ``linear_b_bn``) -> relu -> ``logits_out_b2`` (+ ``final_bn``), then
    each row divided by its L2 norm (taken in fp32, at least 1e-6)."""

    def __init__(self, dim_in, mid_dim, out_dim, with_bn=False,
                 final_bn=False, normalize=True):
        super().__init__()
        self.linear_a = nn.Linear(dim_in, mid_dim)
        self.linear_b = nn.Linear(mid_dim, mid_dim)
        self.logits_out_b2 = nn.Linear(mid_dim, out_dim)
        if with_bn:
            self.linear_a_bn = _bn(mid_dim)
            self.linear_b_bn = _bn(mid_dim)
        if final_bn:
            self.final_bn = _bn(out_dim)
        self.normalize = normalize

    def forward(self, x):
        x = self.linear_a(x)
        if hasattr(self, "linear_a_bn"):
            x = self.linear_a_bn(x)
        x = self.linear_b(F.relu(x))
        if hasattr(self, "linear_b_bn"):
            x = self.linear_b_bn(x)
        x = self.logits_out_b2(F.relu(x))
        if hasattr(self, "final_bn"):
            x = self.final_bn(x)
        if self.normalize:
            norm = torch.linalg.vector_norm(x.to(island_dtype(x)), dim=-1,
                                            keepdim=True)
            x = x / norm.clamp_min(1e-6).to(x.dtype)
        return x


def _pool(x):
    if isinstance(x, dict):
        x = x.get("features", x)
    if x.dim() == 5:
        x = x.mean(dim=(2, 3, 4))
    return x


def _mlp(cfg, dim_in, final_bn=False):
    c = cfg.PRETRAIN.CONTRASTIVE
    return ProjectionMLP(dim_in, int(c.HEAD_MID_DIM), int(c.HEAD_OUT_DIM),
                         with_bn=bool(c.get("HEAD_BN", False)),
                         final_bn=final_bn)


@HEAD_REGISTRY.register()
class ContrastiveHead(nn.Module):
    """Pool, then the projection ``mlp``. Returns (pooled features,
    normalised embeddings)."""

    def __init__(self, cfg, dim_in):
        super().__init__()
        self.mlp = _mlp(cfg, dim_in, bool(cfg.PRETRAIN.CONTRASTIVE.get(
            "FINAL_BN", False)))

    def forward(self, x):
        x = _pool(x)
        return x, self.mlp(x)


class _PairScorer(nn.Module):
    """``fc2(relu(fc1(pair)))``: one score a pair."""

    def __init__(self, dim_in):
        super().__init__()
        self.fc1 = nn.Linear(dim_in, 256)
        self.fc2 = nn.Linear(256, 1)

    def forward(self, p):
        return self.fc2(F.relu(self.fc1(p)))


def _pair_map(z, scorer):
    """(M, M, 2): for each (i, j) the scores of ``[z_i, z_j]`` and of
    ``[z_j, z_i]``, one scorer for both orders."""
    m, d = z.shape
    a = z[:, None, :].expand(m, m, d)
    b = z[None, :, :].expand(m, m, d)
    return torch.cat([scorer(torch.cat([a, b], dim=-1)),
                      scorer(torch.cat([b, a], dim=-1))], dim=-1)


class TopicalPredictor(nn.Module):
    """The projection ``mlp`` (no final BatchNorm), then the symmetric
    pairwise map (N, N, 2) of the global batch's embeddings."""

    def __init__(self, cfg, dim_in):
        super().__init__()
        self.mlp = _mlp(cfg, dim_in)
        self.topical_predictor = _PairScorer(
            2 * int(cfg.PRETRAIN.CONTRASTIVE.HEAD_OUT_DIM))

    def forward(self, x):
        return _pair_map(gather_with_grad(self.mlp(x)),
                         self.topical_predictor)


class TopicalPredictorPlusPlus(TopicalPredictor):
    """HiCo++'s predictor: the embeddings of adjacent view pairs averaged
    before the pairwise map, which then scores (N/2, N/2) pair groups."""

    def forward(self, x):
        z = gather_with_grad(self.mlp(x))
        n, d = z.shape
        return _pair_map(z.reshape(n // 2, 2, d).mean(dim=1),
                         self.topical_predictor)


@HEAD_REGISTRY.register()
class ContrastiveHeadTopicPred(nn.Module):
    """HiCo: the VCL projection ``mlp_vcl`` and the TCL topical map
    ``mlp_tcl``. Returns (topical map, VCL embeddings)."""

    predictor = TopicalPredictor

    def __init__(self, cfg, dim_in):
        super().__init__()
        self.mlp_vcl = _mlp(cfg, dim_in)
        self.mlp_tcl = self.predictor(cfg, dim_in)

    def forward(self, x):
        x = _pool(x)
        return self.mlp_tcl(x), self.mlp_vcl(x)


@HEAD_REGISTRY.register()
class ContrastiveHeadTopicPredPlusPlus(ContrastiveHeadTopicPred):
    """HiCo++: the VCL projection and the pair-averaged topical map."""

    predictor = TopicalPredictorPlusPlus
