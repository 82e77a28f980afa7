"""Query-time reranking (counterpart of the rerank stage of
aspire_tpu/index/serve.py; the sharded first-stage search and the fused query
path belong to the index slice of the port).

OT second stage: the top candidates' sentence reps go through the batched
Sinkhorn scorer (ops.distances.wasserstein_dist) -- the reference's
caching_scoringmodel rerank path (pp_gen_nearest.py:207-363).
"""
from __future__ import annotations

import torch

from ..core.types import MultiVec
from ..ops.distances import wasserstein_dist, l2max_dist


def _tile_query(q: MultiVec, k: int) -> MultiVec:
    return MultiVec(embed=q.embed.expand(k, *q.embed.shape[1:]),
                    lens=q.lens.expand(k))


def ot_rerank(q: MultiVec, cands: MultiVec, blur: float = 0.05,
              scaling: float = 0.9, temp: float = 1.0, max_iters: int = 128,
              solver: str = "kernel") -> torch.Tensor:
    """Batched Sinkhorn rerank of k candidates against one query.

    q: MultiVec with batch 1; cands: MultiVec with batch k, on the same
    device.  Returns f32[k] OT similarity scores (plan-weighted similarity
    sums).  Serving needs no gradients, so the default solver is the CUDA
    kernel; pass solver='torch' for the differentiable plain solver.  For
    latency-critical serving pass scaling=0.8, max_iters=64 ("fast OT"):
    about half the iterations, scores deviate slightly from parity.
    """
    with torch.no_grad():
        sims, _ = wasserstein_dist(
            _tile_query(q, cands.batch), cands, blur=blur, scaling=scaling,
            temp=temp, return_pair_sims=True, max_iters=max_iters,
            solver=solver)
    return sims


def l2max_rerank(q: MultiVec, cands: MultiVec) -> torch.Tensor:
    """Batched single-match rerank (exact reference scores incl. sqrt)."""
    with torch.no_grad():
        sims, _ = l2max_dist(_tile_query(q, cands.batch), cands,
                             return_pair_sims=True)
    return sims
