"""Diagnostics: print pairwise sentence sims / OT transport plans (the port's
own copy of aspire_tpu/evaluation/diagnostics.py).

Equivalent of the reference's print_cociteabs_sims.py (:1-326): given a pair
of encoded documents, dump the sentence-pair similarity matrix, the OT
marginals, and the transport plan so alignment behaviour can be eyeballed.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.types import MultiVec
from ..ops.distances import wasserstein_dist, l2max_dist


def pair_report(q: MultiVec, c: MultiVec, q_sents: list[str] | None = None,
                c_sents: list[str] | None = None, temp: float = 5000.0,
                out=None) -> dict:
    """Print + return sims, marginals, plan for one (query, cand) pair.

    q, c: MultiVec with batch 1.  The OT solve is the plain PyTorch loop
    (`solver="torch"`), the JAX package's default XLA loop.
    """
    import sys
    out = out or sys.stdout
    ql, cl = int(q.lens[0]), int(c.lens[0])
    with torch.no_grad():
        l2_sims, pair = l2max_dist(q, c, return_pair_sims=True)
        w_sims, (a, b, sims, plan, masked) = wasserstein_dist(
            q, c, temp=temp, return_pair_sims=True, solver="torch")
    a, b = a.cpu().numpy(), b.cpu().numpy()
    sims_np = sims.cpu().numpy()[0, :ql, :cl]
    plan_np = plan.cpu().numpy()[0, :ql, :cl]
    print(f"l2max similarity: {float(l2_sims[0]):.4f}", file=out)
    print(f"otAspire similarity: {float(w_sims[0]):.4f}", file=out)
    print(f"query marginals: {np.round(a[0, :ql], 4)}", file=out)
    print(f"cand marginals:  {np.round(b[0, :cl], 4)}", file=out)
    print("pairwise -L2 sims:", file=out)
    print(np.round(sims_np, 3), file=out)
    print("transport plan:", file=out)
    print(np.round(plan_np, 4), file=out)
    best = np.unravel_index(sims_np.argmax(), sims_np.shape)
    print(f"best single match: q{best[0]} <-> c{best[1]}", file=out)
    if q_sents and c_sents:
        print(f"  q: {q_sents[best[0]]}", file=out)
        print(f"  c: {c_sents[best[1]]}", file=out)
        # top plan cells
        flat = plan_np.ravel()
        for idx in np.argsort(-flat)[:3]:
            i, j = np.unravel_index(idx, plan_np.shape)
            print(f"plan mass {flat[idx]:.4f}: q{i} <-> c{j}", file=out)
            print(f"  q: {q_sents[i]}", file=out)
            print(f"  c: {c_sents[j]}", file=out)
    return {"l2max": float(l2_sims[0]), "ot": float(w_sims[0]),
            "sims": sims_np, "plan": plan_np}
