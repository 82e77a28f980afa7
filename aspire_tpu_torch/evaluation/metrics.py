"""IR ranking metrics (the port's own copy of
aspire_tpu/evaluation/metrics.py: numpy only).

Re-implementation of the metric suite the reference evaluates with
(src/evaluation/utils/metrics.py and its duplicate rank_metrics.py -- both
derived from the public bwhite ranking-metrics gist).  Semantics validated
against the doctest values embedded in the reference docstrings (ported to
tests/test_metrics.py).

All functions take relevance judgements in rank order (element 0 = top-ranked
candidate).
"""
from __future__ import annotations

import numpy as np


def precision_at_k(r, k: int) -> float:
    """Precision over the first k results (binary relevance)."""
    if k < 1:
        raise ValueError("k must be >= 1")
    r = np.asarray(r)[:k] != 0
    if r.size != k:
        raise ValueError("Relevance score length < k")
    return float(np.mean(r))


def r_precision(r) -> float:
    """Precision at the number of relevant documents."""
    r = np.asarray(r) != 0
    z = r.nonzero()[0]
    if not z.size:
        return 0.0
    return float(np.mean(r[: z[-1] + 1]))


def average_precision(r) -> float:
    """Mean of precision@k over the positions of relevant documents."""
    r = np.asarray(r) != 0
    out = [precision_at_k(r, k + 1) for k in range(r.size) if r[k]]
    if not out:
        return 0.0
    return float(np.mean(out))


def mean_average_precision(rs) -> float:
    return float(np.mean([average_precision(r) for r in rs]))


def mean_reciprocal_rank(rs) -> float:
    """Mean of 1/(rank of first relevant result); 0 when none relevant."""
    rs = (np.asarray(r).nonzero()[0] for r in rs)
    return float(np.mean([1.0 / (r[0] + 1) if r.size else 0.0 for r in rs]))


def dcg_at_k(r, k: int, method: int = 0) -> float:
    """Discounted cumulative gain: method 0 gives the top-2 positions weight
    1.0; method 1 discounts from position 2."""
    r = np.asarray(r, dtype=float)[:k]
    if not r.size:
        return 0.0
    if method == 0:
        return float(r[0] + np.sum(r[1:] / np.log2(np.arange(2, r.size + 1))))
    if method == 1:
        return float(np.sum(r / np.log2(np.arange(2, r.size + 2))))
    raise ValueError("method must be 0 or 1.")


def ndcg_at_k(r, k: int, method: int = 0) -> float:
    dcg_max = dcg_at_k(sorted(r, reverse=True), k, method)
    if not dcg_max:
        return 0.0
    return dcg_at_k(r, k, method) / dcg_max


def recall_at_k(ranked_rel, atk: int, max_total_relevant: int) -> float:
    """Recall@k with the total-relevant count capped at max_total_relevant."""
    total_relevant = min(max_total_relevant, int(sum(ranked_rel)))
    if total_relevant <= 0:
        return 0.0
    return float(sum(ranked_rel[:atk])) / total_relevant


def compute_metrics(ranked_judgements, pr_atks=(5, 10, 20),
                    threshold_grade: int = 2) -> dict:
    """Per-query metric dict (reference compute_metrics, metrics.py:244-281).

    Graded judgements feed the NDCG family; binary (>= threshold_grade)
    judgements feed precision/recall/F1/AP/MRR/R-precision.
    """
    metrics = {}
    graded = list(ranked_judgements)
    binary = [1 if rel >= threshold_grade else 0 for rel in graded]
    n = len(graded)
    metrics["ndcg"] = float(ndcg_at_k(graded, n))
    metrics["ndcg@20"] = float(ndcg_at_k(graded, 20))
    metrics["ndcg@50"] = float(ndcg_at_k(graded, 50))
    for atk in (5, 10, 15, 20, 25):
        metrics[f"ndcg%{atk}"] = float(ndcg_at_k(graded, int((atk / 100) * n)))
    max_total_relevant = sum(binary)
    # Pools smaller than the largest @k are padded with non-relevant slots so
    # precision@k stays defined (the reference assumes pools >= 20 and would
    # raise; identical values whenever the pool is large enough).
    padded = binary + [0] * max(0, max(pr_atks) - n)
    for atk in pr_atks:
        rec = recall_at_k(padded, atk, max_total_relevant)
        prec = precision_at_k(padded, atk)
        f1 = 2 * prec * rec / (prec + rec) if (prec + rec) > 0 else 0.0
        metrics[f"precision@{atk}"] = float(prec)
        metrics[f"recall@{atk}"] = float(rec)
        metrics[f"f1@{atk}"] = float(f1)
    metrics["r_precision"] = float(r_precision(binary))
    metrics["av_precision"] = float(average_precision(binary))
    metrics["reciprocal_rank"] = float(mean_reciprocal_rank([binary]))
    return metrics
