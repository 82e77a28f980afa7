"""Batched pairwise Euclidean distances (counterpart of aspire_tpu/ops/cdist.py).

Gram-matrix form ``sqrt(max(|q|^2 + |c|^2 - 2 q.c, 0))`` in true float32: the
scoring contractions of the port never run in TF32, which keeps about three
decimal digits and can flip near-tie rankings.
"""
from __future__ import annotations

import torch


def require_fp32_matmul() -> None:
    """Set and assert full-float32 matrix products on the GPU.

    The counterpart of ``Precision.HIGHEST`` on the scoring contractions.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("could not switch TF32 matrix products off")


def pairwise_l2(q: torch.Tensor, c: torch.Tensor,
                squared: bool = False) -> torch.Tensor:
    """Pairwise L2 distances between two batched point sets.

    q: [..., n, d]; c: [..., m, d] -> f32[..., n, m].
    `squared=True` skips the sqrt.
    """
    require_fp32_matmul()
    q = q.float()
    c = c.float()
    qq = torch.sum(q * q, dim=-1)[..., :, None]
    cc = torch.sum(c * c, dim=-1)[..., None, :]
    qc = torch.matmul(q, c.transpose(-1, -2))
    d2 = torch.clamp_min(qq + cc - 2.0 * qc, 0.0)
    if squared:
        return d2
    # Safe sqrt: d(sqrt)/dx at 0 is inf, which poisons gradients at coincident
    # points (e.g. zero-padded sentence slots).  Double-where keeps the zero
    # and selects a zero subgradient there.  `d2 * 0` (not literal 0) in the
    # else-branch preserves NaN/inf so poisoned activations stay visible to
    # a non-finite-loss guard.
    positive = d2 > 0
    safe = torch.where(positive, d2, torch.ones_like(d2))
    return torch.where(positive, torch.sqrt(safe), d2 * 0.0)
