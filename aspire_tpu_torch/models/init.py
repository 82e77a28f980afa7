"""The JAX package's initial weights: Flax's default initialisers.

The JAX models draw every parameter from Flax's defaults
(``aspire_tpu/models/doc_models.py`` ``init_params``): ``nn.Dense`` kernels
lecun-normal -- a normal truncated at two standard deviations whose spread is
sqrt(1 / fan_in), so drawn at sqrt(1 / fan_in) / 0.87962566103423978 before
the cut -- and zero biases, ``nn.Embed`` tables N(0, 1 / width) untruncated,
LayerNorm scales 1 and offsets 0.  PyTorch's module defaults differ (N(0, 1)
embeddings, uniform biases), so a model trained from scratch on the port
would start elsewhere.  `init_like_flax` redraws a module's parameters in
Flax's distributions from an explicit CPU generator, the same numbers on any
device; JAX's own random bits are not reproduced, only their distributions.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

# the standard deviation of a unit normal truncated at +-2 (Flax's
# variance_scaling divides by it)
TRUNCATED_STD = 0.87962566103423978


def truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """A unit normal truncated at +-2, drawn by rejection: entries outside are
    drawn again until none is (about 5% the first time)."""
    x = torch.randn(shape, generator=generator)
    out = x.abs() > 2.0
    while bool(out.any()):
        x[out] = torch.randn(int(out.sum()), generator=generator)
        out = x.abs() > 2.0
    return x


def init_like_flax(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraws, in place and in module order, every nn.Linear (weight
    lecun-normal with fan_in = in_features, bias 0), nn.Embedding (N(0, 1 /
    embedding_dim)) and nn.LayerNorm (1 and 0) under `module`.  Other
    parameters keep their constructors' values (the scalar mix's layer
    weights are zeros in both packages).  generator: a CPU generator; each
    draw is made on the CPU and copied to the parameter's device."""
    with torch.no_grad():
        for sub in module.modules():
            if isinstance(sub, nn.Linear):
                std = math.sqrt(1.0 / sub.in_features) / TRUNCATED_STD
                sub.weight.copy_(truncated_normal(sub.weight.shape, generator) * std)
                if sub.bias is not None:
                    sub.bias.zero_()
            elif isinstance(sub, nn.Embedding):
                w = torch.randn(sub.weight.shape, generator=generator)
                sub.weight.copy_(w / math.sqrt(sub.embedding_dim))
            elif isinstance(sub, nn.LayerNorm) and sub.elementwise_affine:
                sub.weight.fill_(1.0)
                if sub.bias is not None:
                    sub.bias.zero_()
    return module
