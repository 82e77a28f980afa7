"""The numbers that decide `correct`: each a worst gap between what the timed
path produced and what the reference computes from the same inputs.  Every
gap is relative, so that one limit holds at any scale of the data."""
from __future__ import annotations

import torch

BIG = 1e30          # a gap that cannot be measured (a missing or invalid answer)


def worst_row_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over rows of |got - want|_2 / |want|_2 (rows [..., d])."""
    got, want = got.double().reshape(-1, got.shape[-1]), want.double().reshape(-1, want.shape[-1])
    if not torch.isfinite(got).all():
        return BIG
    num = torch.linalg.vector_norm(got - want, dim=-1)
    den = torch.linalg.vector_norm(want, dim=-1).clamp_min(1e-30)
    return float((num / den).max())


def first_stage_gap(scores: torch.Tensor, ids: torch.Tensor, ref_d2: torch.Tensor) -> float:
    """How far a query's reported top-k lies from the reference's.

    scores f32 [B, k] (-L2 as the entry reports them), ids [B, k], ref_d2
    [B, n_docs] the reference's squared distances.  For each query, in units
    of the median squared distance of its reported documents:
      * each reported score against the reference's for that document;
      * how much nearer the reference's k-th nearest document is than the
        farthest reported one (a better document left out).
    An id out of range or reported twice gives BIG."""
    dev = ref_d2.device
    scores, ids = scores.double().to(dev), ids.long().to(dev)
    n_docs, k = ref_d2.shape[1], ids.shape[1]
    if (ids < 0).any() or (ids >= n_docs).any() or not torch.isfinite(scores).all() \
            or (ids.sort(dim=1).values.diff(dim=1) == 0).any():
        return BIG
    want = torch.gather(ref_d2, 1, ids).double()                # [B, k]
    scale = want.median(dim=1).values.clamp_min(1e-30)
    got = scores * scores
    kth = torch.kthvalue(ref_d2, k, dim=1).values.double()
    each = (got - want).abs().amax(dim=1) / scale
    missed = (want.amax(dim=1) - kth).clamp_min(0.0) / scale
    return float(torch.maximum(each, missed).max())


def score_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the median |want| (a batch of scores)."""
    got, want = got.double().cpu().flatten(), want.double().cpu().flatten()
    if got.numel() != want.numel() or not torch.isfinite(got).all():
        return BIG
    scale = float(want.abs().median().clamp_min(1e-30))
    return float((got - want).abs().max()) / scale
