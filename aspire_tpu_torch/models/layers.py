"""Generic layers (counterpart of aspire_tpu/models/layers.py, itself after
src/learning/models_common/generic_layers.py).

SoftmaxMixLayers lives in encoders.py (BiEncoder's scalar mix).  The rest of
the reference's shared layers are here for model-building parity:
FeedForwardNet (:18-68), GatedAttention (:83-114), StraightThroughEstimator
(:120-136).  No model of the reference consumes them; they are kept as tested
building blocks.  Dense sub-modules carry the Flax names (``lin_0``,
``lin_V``...), so models/convert.py maps their weights like any other.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.types import masked_softmax, require_device

NONLINEARITIES = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
}


class FeedForwardNet(nn.Module):
    """MLP with configurable hidden dims/non-linearity; `score_ffn` drops the
    final non-linearity (attention-score head).  Dropout between layers is
    active in train() mode and uses PyTorch's generator."""

    def __init__(self, in_dim: int, out_dim: int, non_linearity: str = "relu",
                 composition_dims: Sequence[int] = (), dropout_p: float = 0.3,
                 use_bias: bool = True, score_ffn: bool = False,
                 device="cuda"):
        super().__init__()
        self.act = NONLINEARITIES[non_linearity]
        self.dropout_p = dropout_p
        self.score_ffn = score_ffn
        self.composed = bool(composition_dims)
        dims = list(composition_dims) + [out_dim]
        self.n_layers = len(dims)
        dev = require_device(device)
        for i, d in enumerate(dims):
            self.add_module(f"lin_{i}", nn.Linear(in_dim, d, bias=use_bias,
                                                  device=dev))
            in_dim = d

    def forward(self, x):
        if not self.composed:
            return self.act(self.lin_0(x))
        for i in range(self.n_layers):
            x = getattr(self, f"lin_{i}")(x)
            last = i == self.n_layers - 1
            if not (last and self.score_ffn):
                x = self.act(x)
            if not last:
                x = F.dropout(x, self.dropout_p, training=self.training)
        return x


class GatedAttention(nn.Module):
    """Gated attention MIL pooling (Ilse et al. 2018): softmaxed per-position
    weights from tanh(Vx) * sigmoid(Ux)."""

    def __init__(self, in_dim: int, embed_dim: int, device="cuda"):
        super().__init__()
        dev = require_device(device)
        self.lin_V = nn.Linear(in_dim, embed_dim, bias=False, device=dev)
        self.lin_U = nn.Linear(in_dim, embed_dim, bias=False, device=dev)
        self.score_weight = nn.Linear(embed_dim, 1, bias=False, device=dev)

    def forward(self, in_seq, seq_lens):
        # in_seq: [b, t, d]; seq_lens: int[b] -> weights [b, t]
        hidden = torch.tanh(self.lin_V(in_seq))
        gates = torch.sigmoid(self.lin_U(in_seq))
        scores = self.score_weight(hidden * gates)[..., 0]
        return masked_softmax(scores, seq_lens)


class _StraightThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return (x >= 0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.clamp(-1.0, 1.0)


def straight_through(x: torch.Tensor) -> torch.Tensor:
    """Binary step with the reference's straight-through gradient
    (generic_layers.py:120-136): the backward returns hardtanh(grad_output)
    -- the incoming gradient clamped to [-1, 1], independent of x."""
    return _StraightThrough.apply(x)
