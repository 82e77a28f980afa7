"""Evaluation protocols: per-query metrics -> aggregate scores (the port's
own copy of aspire_tpu/evaluation/protocols.py, with its own
csfcube_folds.json).

Two stacks mirrored from the reference:

  * CSFCube 2-fold cross-validation over the paper's fixed per-facet query
    splits (ranking_eval.py:18-80,216-322): dev = mean over fold1 only,
    test = mean of (fold1 mean, fold2 mean).  The fold query lists ship as
    data in csfcube_folds.json.
  * split aggregation for RELISH/TRECCOVID/SciDocs (evaluate.py:85-160):
    mean per metric over the dev/test query lists from
    {name}-evaluation_splits.json.

Plus Welch t-tests for method comparison (ranking_eval.py:611-713).
"""
from __future__ import annotations

import json
import pathlib
from statistics import mean

import numpy as np

from .metrics import compute_metrics

_FOLDS_PATH = pathlib.Path(__file__).parent / "csfcube_folds.json"

AGG_METRICS = (
    "precision@5", "precision@10", "precision@20", "recall@20", "f1@20",
    "r_precision", "av_precision", "reciprocal_rank", "ndcg", "ndcg@20",
    "ndcg@50", "ndcg%5", "ndcg%10", "ndcg%15", "ndcg%20", "ndcg%25",
)

# reference names a few aggregates differently (ranking_eval.py:303-306)
_RENAME = {"av_precision": "mean_av_precision",
           "reciprocal_rank": "mean_reciprocal_rank"}


def load_csfcube_folds() -> dict:
    with open(_FOLDS_PATH) as f:
        return json.load(f)


def per_query_metrics(ranked_relevances: dict, threshold_grade: int = 2) -> dict:
    """{qid: ranked graded judgements} -> {qid: metric dict}."""
    return {qid: compute_metrics(rels, pr_atks=(5, 10, 20),
                                 threshold_grade=threshold_grade)
            for qid, rels in ranked_relevances.items()}


def aggregate_crossval(query_metrics: dict, facet: str, split: str) -> dict:
    """CSFCube protocol: dev uses fold1 only; test averages the two folds."""
    folds = load_csfcube_folds()[facet]
    fold_names = [f"fold1_{split}"] if split == "dev" else \
        [f"fold1_{split}", f"fold2_{split}"]
    per_fold: dict[str, list[float]] = {m: [] for m in AGG_METRICS}
    for fold in fold_names:
        qids = folds[fold]
        for m in AGG_METRICS:
            per_fold[m].append(mean(query_metrics[q][m] for q in qids))
    return {_RENAME.get(m, m): mean(v) for m, v in per_fold.items()}


def aggregate_split(query_metrics: dict, split_qids: list | None = None) -> dict:
    """Plain mean over (a split of) queries (evaluate.py aggregation)."""
    qids = list(query_metrics) if split_qids is None else \
        [q for q in split_qids if q in query_metrics]
    return {_RENAME.get(m, m): mean(query_metrics[q][m] for q in qids)
            for m in AGG_METRICS}


def aggregate_protocol(dataset, query_metrics: dict,
                       facet: str | None) -> dict:
    """Dataset-appropriate {split: aggregate} dispatch, shared by the
    evaluate and ranking-eval stacks: CSFCube aggregates by the 2-fold
    cross-val protocol keyed '{qid}_{facet}'; other datasets by their
    dev/test splits (plain mean when a dataset has no split)."""
    results = {}
    if dataset.name == "csfcube":
        if facet is None:
            raise ValueError("CSFCube is evaluated per facet")
        keyed = {f"{q}_{facet}": m for q, m in query_metrics.items()}
        for split in ("dev", "test"):
            results[split] = aggregate_crossval(keyed, facet, split)
    else:
        splits = dataset.get_test_dev_split()
        if splits is None:
            results["test"] = aggregate_split(query_metrics)
        else:
            for split in ("dev", "test"):
                qids = [str(q) for q in splits.get(split, [])]
                results[split] = aggregate_split(query_metrics, split_qids=qids)
    return results


def significance_test(per_query_a: dict, per_query_b: dict,
                      metric: str = "av_precision", n_comparisons: int = 1):
    """Welch's t-test between two methods' per-query metric values with a
    Bonferroni-adjusted significance level (ranking_eval.py:611-713).

    Returns (t_stat, p_value, significant_at_005).
    """
    from scipy import stats
    qids = sorted(set(per_query_a) & set(per_query_b))
    a = np.array([per_query_a[q][metric] for q in qids])
    b = np.array([per_query_b[q][metric] for q in qids])
    t, p = stats.ttest_ind(a, b, equal_var=False)
    return float(t), float(p), bool(p < 0.05 / max(1, n_comparisons))


def rank_candidates(scores: dict) -> dict:
    """{qid: {cand: similarity}} -> {qid: [(cand, score) desc-sorted]}."""
    return {qid: sorted(cands.items(), key=lambda kv: kv[1], reverse=True)
            for qid, cands in scores.items()}


class PoolMismatchError(ValueError):
    """Ranked output disagrees with the gold candidate pools.

    The reference's evaluation is POOL RE-RANKING: every ranked candidate
    must come from the query's gold pool, and the full pool must be ranked
    (pp_gen_nearest.py:241-283).  Global-top-k output over a corpus that is
    a superset of the pools violates both; this error names the first
    offender instead of dying in a bare KeyError deep in metric code."""


def ranked_relevances(ranked: dict, gold: dict,
                      on_missing: str = "error") -> dict:
    """{qid: [(cand, score)]} + gold {qid: {cand: rel}} -> ranked judgements.

    on_missing: 'error' (default) raises PoolMismatchError on the first
    out-of-pool candidate or query without gold anns.  'intersect' scores
    the gold-pool intersection with a loud warning: out-of-pool candidates
    are dropped, and pool candidates the ranking OMITTED are appended at the
    end as if ranked last -- metric denominators are derived from the
    judgement list itself (compute_metrics), so omitted relevant docs must
    stay IN the list to count as misses; silently shrinking the list would
    inflate recall/MAP instead."""
    import logging
    out = {}
    n_dropped = n_appended = 0
    for qid, cands in ranked.items():
        if qid not in gold:
            raise PoolMismatchError(
                f"query {qid!r} has ranked output but no gold annotations: "
                "the ranked file and test-pid2anns pools disagree (wrong "
                "--dataset/--facet, or ranking ran on a different corpus)")
        g = gold[qid]
        missing = [c for c, _ in cands if c not in g]
        if missing and on_missing == "error":
            raise PoolMismatchError(
                f"candidate {missing[0]!r} ranked for query {qid!r} is not "
                f"in its gold pool ({len(missing)}/{len(cands)} ranked "
                "candidates are out-of-pool). The ranking was computed over "
                "a corpus larger than the query's candidate pool -- use the "
                "pool protocol (`rank` ranks pools by default when the "
                "dataset ships test-pid2anns) or pass on_missing="
                "'intersect' to score the gold-pool intersection only")
        n_dropped += len(missing)
        seen = {c for c, _ in cands if c in g}
        omitted = [c for c in g if c not in seen]
        n_appended += len(omitted)
        out[qid] = [g[c] for c, _ in cands if c in g] + [g[c] for c in omitted]
    if n_dropped or n_appended:
        logging.getLogger(__name__).warning(
            "pool-incomplete ranking scored on the gold-pool INTERSECTION: "
            "dropped %d out-of-pool ranked candidates, appended %d omitted "
            "pool candidates at the bottom of their rankings (they count as "
            "worst-ranked in recall/MAP/NDCG)", n_dropped, n_appended)
    return out
