"""Multi-vector pair scoring / distance functions (the framework's math core).

Counterpart of aspire_tpu/ops/distances.py, itself a re-design of
src/learning/facetid_models/pair_distances.py.  Documents arrive as
`MultiVec` (zero-padded `[batch, max_sents, dim]` embeddings + int lengths)
and all per-example mask loops are broadcast masks.

Train-time functions return positive "distances" (to be minimized inside a
triplet loss); test-time variants (`return_pair_sims=True`) return
similarities plus per-pair diagnostics, mirroring the reference contracts.
"""
from __future__ import annotations

import math

import torch

from ..core.types import MultiVec, masked_2d_softmax
from ..utils.profiling import span
from .cdist import pairwise_l2, require_fp32_matmul
from .sinkhorn import resolve_diameter, sinkhorn_cost, sinkhorn_potentials
from .sinkhorn_kernel import sinkhorn_potentials_kernel


def _masked_neg_dists(query: MultiVec, cand: MultiVec,
                      cost: torch.Tensor | None = None) -> torch.Tensor:
    """-cdist(q, c) with -10e8 added at pad positions
    (pair_distances.py:49-56).  cost: optional precomputed pairwise_l2."""
    if cost is None:
        cost = pairwise_l2(query.embed, cand.embed)
    return -cost + query.pair_pad_mask(cand)


def l2max_dist(query: MultiVec, cand: MultiVec, return_pair_sims: bool = False):
    """Single best sentence match: max over the masked -L2 matrix.

    Reference: allpair_masked_dist_l2max (pair_distances.py:138-186).
    Train -> positive distance f32[batch]; test -> (sims, pair_sims).
    """
    neg = _masked_neg_dists(query, cand)
    best = neg.reshape(neg.shape[0], -1).max(dim=1).values
    if return_pair_sims:
        return best, neg
    return -best


def l2topk_dist(query: MultiVec, cand: MultiVec, k: int = 2,
                return_pair_sims: bool = False):
    """Top-k sentence matches summed (reference k=2).

    Reference: allpair_masked_dist_l2topk (pair_distances.py:295-345).
    """
    neg = _masked_neg_dists(query, cand)
    topk = torch.topk(neg.reshape(neg.shape[0], -1), k, dim=1).values
    if return_pair_sims:
        return topk.sum(dim=1), neg
    return -topk.sum(dim=1)


def _aligned_neg(query: MultiVec, cand: MultiVec) -> torch.Tensor:
    qi = torch.minimum(cand.align[:, 0], query.lens - 1).long()
    ci = torch.minimum(cand.align[:, 1], cand.lens - 1).long()
    neg = -pairwise_l2(query.embed, cand.embed)
    return neg[torch.arange(neg.shape[0], device=neg.device), qi, ci]


def l2sup_dist(query: MultiVec, cand: MultiVec) -> torch.Tensor:
    """Distance of the pre-aligned sentence pair (tsAspire supervision).

    `cand.align` holds (query_sent_idx, cand_sent_idx) per example; indices are
    clipped to the valid lengths.  Reference: allpair_masked_dist_l2sup
    (pair_distances.py:189-235).
    """
    return -_aligned_neg(query, cand)


def l2sup_weighted_dist(query: MultiVec, cand: MultiVec) -> torch.Tensor:
    """l2sup divided by the cross-doc matrix size ql*cl (for OT multitasking).

    Reference: allpair_masked_dist_l2sup_weighted (pair_distances.py:238-292).
    """
    picked = _aligned_neg(query, cand)
    sizes = (query.lens * cand.lens).to(picked.dtype)
    return -(picked / sizes)


def attention_dist(query: MultiVec, cand: MultiVec, temp: float = 1.0,
                   return_pair_sims: bool = False):
    """Masked joint-2D-softmax attention distance (attAspire).

    Reference: AllPairMaskedAttention.compute_distance
    (pair_distances.py:95-135).  The distance matrix is NOT pad-masked before
    the softmax -- masked_2d_softmax supplies the masking.
    """
    neg = -pairwise_l2(query.embed, cand.embed)
    pair_sm = masked_2d_softmax(neg / temp, query.lens, cand.lens)
    if return_pair_sims:
        masked_sims = pair_sm * neg
        return masked_sims.sum(dim=(1, 2)), (neg, pair_sm, masked_sims)
    return (pair_sm * (-neg)).sum(dim=(1, 2))


def ot_marginals(query: MultiVec, cand: MultiVec, temp: float = 1.0,
                 cost: torch.Tensor | None = None):
    """Marginal distributions over sentences for the OT solver.

    softmax over (max-similarity to the other doc) / temp on the pad-masked
    -L2 matrix, so pad sentences get ~zero mass (pair_distances.py:57-60).
    Returns (a, b, masked_neg_dists).
    """
    neg = _masked_neg_dists(query, cand, cost=cost)
    a = torch.softmax(neg.max(dim=2).values / temp, dim=1)
    b = torch.softmax(neg.max(dim=1).values / temp, dim=1)
    return a, b, neg


SOLVERS = ("auto", "torch", "kernel", "kernel_loop")


def _select_solver(solver: str, reach: float | None, on_cuda: bool) -> str:
    """The OT solver route, keyed on where the inputs lie.

      * 'auto' on CUDA with reach=None -> 'kernel_loop'; on the CPU, or with
        `reach` set (unbalanced OT, which the kernel does not solve, as the
        JAX package's Pallas kernel does not), -> 'torch'.
      * 'torch': the annealing loop as PyTorch rounds, the final step with
        gradients (ops/sinkhorn.py) -- the yardstick.
      * 'kernel_loop': the annealing loop as one launch of the CUDA kernel in
        its loop-only mode, the final step in PyTorch with gradients: the
        same gradients as 'torch', and no host sync.  Balanced OT only.
      * 'kernel': the CUDA kernel takes the final step too (forward-only,
        balanced OT): the serving and rerank path.
    On CPU tensors either kernel route runs the kernel's plain version.
    """
    if solver not in SOLVERS:
        raise ValueError(f"solver must be one of {SOLVERS}, got {solver!r}")
    if solver in ("kernel", "kernel_loop") and reach is not None:
        raise ValueError(f"solver={solver!r} supports balanced OT only "
                         "(reach=None)")
    if solver == "auto":
        return "kernel_loop" if on_cuda and reach is None else "torch"
    return solver


def wasserstein_dist(
    query: MultiVec,
    cand: MultiVec,
    blur: float = 0.05,
    scaling: float = 0.9,
    reach: float | None = None,
    temp: float = 1.0,
    return_pair_sims: bool = False,
    max_iters: int = 128,
    diameter: str = "global",
    solver: str = "auto",
    diameter_value: torch.Tensor | None = None,
):
    """Optimal-transport multi-match scoring (otAspire).

    Reference: AllPairMaskedWasserstein.compute_distance
    (pair_distances.py:14-92).  Train -> Sinkhorn OT cost (gradients flow
    through the final extrapolation step as in geomloss).  Test -> transport
    plan recovered from the dual potentials and the plan-weighted similarity
    sum, plus diagnostics [q_distr, c_distr, pair_sims, plan, masked_sims].

    solver: 'auto' (default), 'torch', 'kernel_loop' or 'kernel'; see
    `_select_solver`.  'auto' is 'kernel_loop' on CUDA tensors with
    reach=None (the training loss: one kernel launch, differentiable) and
    'torch' otherwise.
    diameter_value: the annealing's starting diameter, a scalar or f32[bsz],
    instead of the one `diameter` names.  With `grouped_max_diameter` of the
    batch one call gives what a loop of separate 'global' calls on equal
    slices of it would (the grouped training loss, one slice a micro batch).
    """
    route = _select_solver(solver, reach, query.embed.is_cuda)
    with span("cost"):
        cost = pairwise_l2(query.embed, cand.embed)
        a, b, neg = ot_marginals(query, cand, temp=temp, cost=cost)
    if diameter_value is None:
        with span("diameter"):
            diameter_value = resolve_diameter(query.embed, cand.embed, a, b,
                                              diameter, None)

    def _solve():
        with span("solve"):
            if route == "kernel":
                return sinkhorn_potentials_kernel(
                    a, query.embed, b, cand.embed, blur=blur, scaling=scaling,
                    max_iters=max_iters, cost=cost, use_cost=True,
                    diameter_value=diameter_value)
            return sinkhorn_potentials(
                a, query.embed, b, cand.embed, blur=blur, scaling=scaling,
                reach=reach, max_iters=max_iters, cost=cost, use_cost=True,
                diameter_value=diameter_value,
                loop="kernel" if route == "kernel_loop" else "torch")

    if not return_pair_sims:
        f, g = _solve()
        return sinkhorn_cost(a, f, b, g, blur=blur, reach=reach)

    # Test path: zero the pads multiplicatively (the reference flips its
    # additive mask into a binary one in place, pair_distances.py:64-66).
    binary = query.sent_mask()[:, :, None] * cand.sent_mask()[:, None, :]
    masked_neg = neg * binary
    f, g = _solve()
    outersum = (f[:, :, None] + g[:, None, :]) * binary
    exps = torch.exp((outersum + masked_neg) / blur)
    plan = exps * (a[:, :, None] * b[:, None, :])
    masked_sims = plan * masked_neg
    return masked_sims.sum(dim=(1, 2)), (a, b, masked_neg, plan, masked_sims)


def jointsm_dist(query: MultiVec, cand: MultiVec, return_pair_sims: bool = False):
    """Poly-encoder style joint-softmax alignment score.

    Reference: allpair_joint_sm_negscore (pair_distances.py:348-402).  Scaled
    dot-product similarities, a joint 2-D masked softmax, and symmetric
    aligned-rep dot scores; returns the negated summed score.
    """
    require_fp32_matmul()   # scoring contractions never run in TF32
    qe, ce = query.embed.float(), cand.embed.float()
    sims = torch.matmul(qe, ce.transpose(1, 2))
    pair_sm = masked_2d_softmax(sims / math.sqrt(query.dim), query.lens,
                                cand.lens)
    cand2query = torch.matmul(pair_sm, ce)                    # [b, q, d]
    query2cand = torch.matmul(pair_sm.transpose(1, 2), qe)    # [b, c, d]
    q_scores = (qe * cand2query).sum(dim=2)
    c_scores = (ce * query2cand).sum(dim=2)
    summed = q_scores.sum(dim=1) + c_scores.sum(dim=1)
    if return_pair_sims:
        return -summed, pair_sm
    return -summed


def get_dist_function(score_agg_type: str, hp=None, solver: str = "auto"):
    """Distance-function registry keyed by the reference's config names
    (disent_models.py:236-247).  solver: the OT solver of 'l2wasserstein'
    (see `wasserstein_dist`)."""
    if score_agg_type in ("l2max", "l2lse"):
        return l2max_dist
    if score_agg_type == "l2top2":
        return l2topk_dist
    if score_agg_type == "l2wasserstein":
        blur = getattr(hp, "geoml_blur", 0.05) if hp is not None else 0.05
        scaling = getattr(hp, "geoml_scaling", 0.9) if hp is not None else 0.9
        reach = getattr(hp, "geoml_reach", None) if hp is not None else None
        temp = getattr(hp, "sent_sm_temp", 1.0) if hp is not None else 1.0
        _select_solver(solver, reach, on_cuda=False)     # refuses bad values now

        def fn(query, cand, return_pair_sims=False, diameter_value=None):
            return wasserstein_dist(
                query, cand, blur=blur, scaling=scaling, reach=reach,
                temp=temp, return_pair_sims=return_pair_sims,
                diameter_value=diameter_value, solver=solver)
        return fn
    if score_agg_type == "l2attention":
        temp = getattr(hp, "cdatt_sm_temp", 1.0) if hp is not None else 1.0

        def fn(query, cand, return_pair_sims=False):
            return attention_dist(query, cand, temp=temp,
                                  return_pair_sims=return_pair_sims)
        return fn
    if score_agg_type == "jointsm":
        return jointsm_dist
    raise ValueError(f"Unknown aggregation: {score_agg_type}")
