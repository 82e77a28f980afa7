"""Core structs used across the port (counterpart of aspire_tpu/core/types.py).

Multi-vector document representations travel as ``MultiVec``: embeddings
row-major ``[batch, max_sents, dim]`` zero-padded past ``lens``, lengths as an
integer tensor, masks derived on the fly.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

# The reference uses -10e8 (== -1e9) as the additive pad-mask value
# (src/learning/facetid_models/pair_distances.py:39).  Keep the exact constant:
# downstream softmaxes and max-reductions depend on it.
PAD_NEG = -10e8

# Mask value used by the reference's masked softmaxes
# (src/learning/models_common/activations.py:25,52-53).
SOFTMAX_NEG = -1e32


def require_device(device) -> torch.device:
    """Resolve an explicit device argument; a CUDA request without CUDA raises.

    Nothing in the port looks for a GPU and carries on without one: the
    default everywhere is ``"cuda"`` and the CPU is used only when asked for.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run on the CPU")
    return dev


@dataclass
class MultiVec:
    """A batch of multi-vector (per-sentence) document representations.

    embed: f32[batch, max_sents, dim] -- contextual sentence embeddings,
        zero-padded past `lens`.
    lens:  int[batch] -- number of valid sentences per document.
    align: optional int[batch, 2] -- (query_sent_idx, cand_sent_idx) supervised
        alignment pairs (reference `align_idxs`, pair_distances.py:206).
    """

    embed: torch.Tensor
    lens: torch.Tensor
    align: torch.Tensor | None = None

    @property
    def batch(self) -> int:
        return self.embed.shape[0]

    @property
    def max_sents(self) -> int:
        return self.embed.shape[1]

    @property
    def dim(self) -> int:
        return self.embed.shape[2]

    def to(self, device) -> "MultiVec":
        return MultiVec(
            embed=self.embed.to(device), lens=self.lens.to(device),
            align=None if self.align is None else self.align.to(device))

    def sent_mask(self) -> torch.Tensor:
        """[batch, max_sents] in embed's dtype; 1.0 at valid sentences."""
        pos = torch.arange(self.max_sents, device=self.embed.device)[None, :]
        return (pos < self.lens[:, None]).to(self.embed.dtype)

    def pair_pad_mask(self, other: "MultiVec") -> torch.Tensor:
        """[batch, self.max_sents, other.max_sents]; PAD_NEG additive mask.

        0.0 inside the (ql, cl) valid rectangle, -10e8 outside
        (pair_distances.py:39-43).
        """
        m = self.sent_mask()[:, :, None] * other.sent_mask()[:, None, :]
        return (1.0 - m) * PAD_NEG


def masked_softmax(scores: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Softmax over axis 1 restricted to the first `lens` positions.

    Mirrors src/learning/models_common/activations.py:10-32 (additive -1e32
    mask).  scores: [batch, n]; lens: int[batch].
    """
    n = scores.shape[1]
    pos = torch.arange(n, device=scores.device)[None, :]
    mask = torch.where(pos < lens[:, None], 0.0, SOFTMAX_NEG).to(scores.dtype)
    return torch.softmax(scores + mask, dim=1)


def masked_2d_softmax(scores: torch.Tensor, lens1: torch.Tensor,
                      lens2: torch.Tensor) -> torch.Tensor:
    """Joint softmax over the flattened last two axes, masked to the valid
    (lens1, lens2) rectangle per batch element.

    Mirrors src/learning/models_common/activations.py:35-61.
    scores: [batch, n1, n2].
    """
    b, n1, n2 = scores.shape
    p1 = torch.arange(n1, device=scores.device)[None, :, None]
    p2 = torch.arange(n2, device=scores.device)[None, None, :]
    valid = (p1 < lens1[:, None, None]) & (p2 < lens2[:, None, None])
    masked = scores + torch.where(valid, 0.0, SOFTMAX_NEG).to(scores.dtype)
    flat = torch.softmax(masked.reshape(b, n1 * n2), dim=1)
    return flat.reshape(b, n1, n2)
