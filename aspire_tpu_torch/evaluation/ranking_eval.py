"""Legacy-stack evaluation: consume pre-ranked pool files (the port's own
copy of aspire_tpu/evaluation/ranking_eval.py).

Mirrors src/evaluation/ranking_eval.py:447-608 -- reads
`test-pid2pool-{dataset}-{method}[-facet]-ranked.json` + gold annotations,
computes per-query metrics, aggregates by the CSFCube cross-val protocol or
the dataset splits, and prints the headline table (R-Prec, P@{5,10,20},
Recall@20, MAP, NDCG, NDCG@20, NDCG%20).  Also writes the per-query
readable-neighbours text dumps the reference produces for eyeballing
(pp_gen_nearest.py:575-635).
"""
from __future__ import annotations

import codecs
import json
import logging
import os

from .datasets import EvalDataset
from .protocols import (
    per_query_metrics, aggregate_protocol, ranked_relevances,
)

log = logging.getLogger(__name__)

HEADLINE = ("r_precision", "precision@5", "precision@10", "precision@20",
            "recall@20", "mean_av_precision", "ndcg", "ndcg@20", "ndcg%20")


def ranked_pool_filename(data_dir: str, dataset: str, method: str,
                         facet: str | None = None) -> str:
    suffix = f"-{facet}" if facet else ""
    return os.path.join(data_dir, f"test-pid2pool-{dataset}-{method}{suffix}-ranked.json")


def eval_pool_ranking(data_dir: str, dataset_name: str, method: str,
                      dataset_dir: str | None = None,
                      facet: str | None = None,
                      on_missing: str = "error") -> dict:
    """-> {split: aggregate metrics}; prints the headline row per split.

    on_missing: 'error' (default) raises protocols.PoolMismatchError when
    the ranked file contains out-of-pool candidates; 'intersect' scores the
    gold-pool intersection with omitted pool members ranked last (loudly)."""
    ds = EvalDataset(dataset_name, dataset_dir or data_dir)
    with codecs.open(ranked_pool_filename(data_dir, dataset_name, method, facet),
                     "r", "utf-8") as f:
        ranked = json.load(f)
    gold = ds.get_gold_test_data(facet=facet)
    ranked_pairs = {}
    for qid, cands in ranked.items():
        # accept both [[cand, score], ...] and [cand, ...] formats
        ranked_pairs[qid] = [(c[0], c[1]) if isinstance(c, (list, tuple))
                             else (c, 0.0) for c in cands]
    rels = ranked_relevances(ranked_pairs, gold, on_missing=on_missing)
    qmetrics = per_query_metrics(rels, threshold_grade=ds.get_threshold_grade())

    results = aggregate_protocol(ds, qmetrics, facet)
    for split, agg in results.items():
        row = "  ".join(f"{k}={agg[k]:.4f}" for k in HEADLINE if k in agg)
        log.info("%s/%s %s [%s]: %s", dataset_name, method, split,
                 facet or "unfaceted", row)
    return results


def print_pool_neighbours(dataset: EvalDataset, ranked: dict, out_path: str,
                          top_k: int = 10) -> None:
    """Human-readable per-query neighbour dumps (pp_gen_nearest.py:575-635)."""
    os.makedirs(out_path, exist_ok=True)
    for qpid, cands in ranked.items():
        qdoc = dataset.get(qpid)
        with codecs.open(os.path.join(out_path, f"{qpid}-neighbours.txt"),
                         "w", "utf-8") as f:
            f.write(f"QUERY: {qpid}\n")
            f.write(f"TITLE: {qdoc['TITLE']}\n")
            f.write("ABSTRACT: " + " ".join(qdoc["ABSTRACT"]) + "\n")
            f.write("=" * 80 + "\n")
            for rank, item in enumerate(cands[:top_k]):
                cpid, score = (item[0], item[1]) if isinstance(item, (list, tuple)) \
                    else (item, float("nan"))
                cdoc = dataset.get(cpid)
                f.write(f"RANK {rank}; PID {cpid}; SCORE {score:.4f}\n")
                f.write(f"TITLE: {cdoc['TITLE']}\n")
                f.write("ABSTRACT: " + " ".join(cdoc["ABSTRACT"]) + "\n")
                f.write("-" * 80 + "\n")
