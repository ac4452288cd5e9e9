"""The transformer classification heads (port of
``dist_tpu/models/heads/transformer_head.py``): dropout, an optional
tanh pre-logits layer, the linear layer; in eval mode softmax (or
sigmoid) in fp32. Their dense layers keep the port's LeCun-normal init."""

import torch
import torch.nn as nn
import torch.nn.functional as F

from dist_tpu_torch.models.base.models import HEAD_REGISTRY, _eval_activation


def _features(x):
    if isinstance(x, dict):
        x = x.get("features", x.get("vid_logits"))
    return x


@HEAD_REGISTRY.register()
class TransformerHead(nn.Module):
    """``(B, dim_in)`` features -> dropout -> (``pre_logits``: tanh of
    ``pre_logits_fc``) -> ``linear``. Returns ``(preds, features)``."""

    def __init__(self, dim_in, num_classes, dropout_rate=0.0,
                 activation="softmax", pre_logits=False):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.activation = activation
        if pre_logits:
            self.pre_logits_fc = nn.Linear(dim_in, dim_in)
        self.linear = nn.Linear(dim_in, num_classes)

    def forward(self, x):
        feat = x = _features(x)
        if self.dropout_rate > 0:
            x = F.dropout(x, self.dropout_rate, self.training)
        if hasattr(self, "pre_logits_fc"):
            x = torch.tanh(self.pre_logits_fc(x))
        out = self.linear(x)
        if not self.training:
            out = _eval_activation(out, self.activation)
        return out, feat


@HEAD_REGISTRY.register()
class TransformerHeadx2(nn.Module):
    """The dual verb/noun head: ``linear1`` and ``linear2`` over the
    features after dropout. Returns ``({"verb_class", "noun_class"},
    features)``."""

    def __init__(self, dim_in, num_classes, dropout_rate=0.0,
                 activation="softmax"):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.activation = activation
        self.linear1 = nn.Linear(dim_in, num_classes[0])
        self.linear2 = nn.Linear(dim_in, num_classes[1])

    def forward(self, x):
        feat = x = _features(x)
        if self.dropout_rate > 0:
            x = F.dropout(x, self.dropout_rate, self.training)
        outs = {}
        for key, linear in (("verb_class", self.linear1),
                            ("noun_class", self.linear2)):
            o = linear(x)
            outs[key] = o if self.training else _eval_activation(
                o, self.activation)
        return outs, feat
