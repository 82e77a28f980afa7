"""End-to-end evaluation pipeline: encode -> score -> evaluate (the port's own
copy of aspire_tpu/evaluation/evaluate.py; its CSVs are written by the `csv`
module with pandas' columns, order and values).

Mirrors src/evaluation/evaluate.py:15-212 with the per-candidate scoring loop
replaced by one batched device call per query chunk (SimilarityModel
.get_similarities), and aggregation driven by the protocol helpers.

Artifacts (reference file contracts, utils/utils.py:29-69):
  {results_dir}/scores[-facet].json        ranked [cand, score] lists per query
  {results_dir}/query-evaluations[-facet].csv
  {results_dir}/aggregated-evaluations[-facet].csv
  {cache_dir}/encodings.h5                 pid -> encoding cache
"""
from __future__ import annotations

import codecs
import csv
import json
import logging
import math
import os

from .datasets import EvalDataset, FACETS
from .models import SimilarityModel
from .protocols import (
    per_query_metrics, aggregate_crossval, aggregate_protocol, rank_candidates,
    ranked_relevances,
)

log = logging.getLogger(__name__)


def scores_filename(results_dir: str, facet=None) -> str:
    name = "scores.json" if facet is None else f"scores-{facet}.json"
    return os.path.join(results_dir, name)


def evaluations_filename(results_dir: str, facet, aggregated: bool) -> str:
    kind = "aggregated" if aggregated else "query"
    name = f"{kind}-evaluations.csv" if facet is None else f"{kind}-evaluations-{facet}.csv"
    return os.path.join(results_dir, name)


def write_csv(path: str, rows: list[dict]) -> None:
    """rows -> CSV as pandas' `DataFrame(rows).to_csv(index=False)` writes
    it: the columns in order of first appearance, floats as their repr, NaN
    and None as empty fields."""
    cols: list = []
    for r in rows:
        cols.extend(k for k in r if k not in cols)

    def cell(v):
        if v is None or (isinstance(v, float) and math.isnan(v)):
            return ""
        return v

    with open(path, "w", newline="", encoding="utf-8") as f:
        if not cols:
            f.write("\n")
            return
        w = csv.writer(f, lineterminator="\n")
        w.writerow(cols)
        for r in rows:
            w.writerow([cell(r.get(c)) for c in cols])


def encode_dataset(model: SimilarityModel, dataset: EvalDataset,
                   cache_path: str | None = None) -> None:
    """Encode every uncached paper in the dataset (evaluate.py:15-32)."""
    if cache_path is not None and model.cache is None:
        # don't reopen an already-attached cache (h5 double-open locks)
        model.set_encodings_cache(cache_path)
    if model.cache is None:
        raise RuntimeError("set a cache before bulk encoding")
    uncached = {pid: dataset.get(pid) for pid, _ in dataset
                if pid not in model.cache}
    from .models import batchify
    for i, (bpids, bpapers) in enumerate(batchify(uncached, model.batch_size)):
        model.cache_encodings(bpids, bpapers)
        if i % 50 == 0:
            log.info("encoded %d batches", i)


def score_dataset(model: SimilarityModel, dataset: EvalDataset,
                  results_dir: str, facet: str | None = None) -> dict:
    """Rank every query's candidate pool; write scores json (evaluate.py:35-82)."""
    os.makedirs(results_dir, exist_ok=True)
    pool = dataset.get_test_pool(facet=facet)
    log.info("scoring %d queries%s", len(pool), f" facet={facet}" if facet else "")
    scores = {}
    for qpid, pool_info in pool.items():
        cands = pool_info["cands"]
        encs = model.get_encoding([qpid] + list(cands), dataset)
        q_enc = encs[qpid]
        if facet is not None:
            q_enc = model.get_faceted_encoding(q_enc, facet, dataset.get(qpid))
        sims = model.get_similarities(q_enc, [encs[c] for c in cands])
        ranked = sorted(zip(cands, (float(s) for s in sims)),
                        key=lambda kv: kv[1], reverse=True)
        # reference file contract stores -1*similarity (a distance), most
        # similar first (evaluate.py:77); metrics consume the ORDER only
        scores[qpid] = [[c, -s] for c, s in ranked]
    with codecs.open(scores_filename(results_dir, facet), "w", "utf-8") as f:
        json.dump(scores, f)
    return scores


def evaluate_scores(results_dir: str, dataset: EvalDataset,
                    facet: str | None = None) -> dict:
    """Per-query metrics + aggregation (evaluate.py:85-160).

    CSFCube aggregates by the 2-fold cross-val protocol; other datasets by
    their dev/test splits.  Returns {split: aggregate metric dict}.
    """
    gold = dataset.get_gold_test_data(facet=facet)
    with codecs.open(scores_filename(results_dir, facet), "r", "utf-8") as f:
        scores = json.load(f)
    ranked = {q: [(c, s) for c, s in v] for q, v in scores.items()}
    rels = ranked_relevances(ranked, gold)
    qmetrics = per_query_metrics(rels, threshold_grade=dataset.get_threshold_grade())

    rows = [{"paper_id": q, **m} for q, m in qmetrics.items()]
    write_csv(evaluations_filename(results_dir, facet, False), rows)

    results = aggregate_protocol(dataset, qmetrics, facet)
    agg_rows = [{"split": s, **m} for s, m in results.items()]
    write_csv(evaluations_filename(results_dir, facet, True), agg_rows)
    for split, m in results.items():
        log.info("%s %s: MAP %.4f ndcg%%20 %.4f", dataset.name, split,
                 m["mean_av_precision"], m["ndcg%20"])
    return results


def run_evaluation(model: SimilarityModel, dataset: EvalDataset,
                   results_dir: str, actions=("encode", "score", "evaluate"),
                   facets=None, cache_path: str | None = None) -> dict:
    """Drive the full pipeline (reference main, evaluate.py:164-212)."""
    if facets is None:
        facets = list(FACETS) if dataset.name == "csfcube" else [None]
    if dataset.name == "csfcube" and None in facets and (
            "score" in actions or "evaluate" in actions):
        # fail BEFORE the (expensive) scoring pass, not at the aggregation
        # assert after it
        raise ValueError("CSFCube is evaluated per facet: pass --facet "
                         "background|method|result, or omit --facet to run "
                         "all three")
    # the cache serves BOTH the encode and score actions (the reference
    # attaches it for either, evaluate.py:186): a score-only run must read
    # the previously built encodings, not silently re-encode per query.
    # Attach only when no cache is open yet: re-attaching over a live h5
    # handle trips HDF5's same-process write lock, and the open-'w'
    # fallback would then TRUNCATE every cached encoding.
    if cache_path is not None and model.cache is None:
        model.set_encodings_cache(cache_path)
    out = {}
    if "encode" in actions:
        if cache_path is not None:
            encode_dataset(model, dataset, cache_path)
        else:
            # without a cache there is nowhere to keep bulk encodings --
            # scoring would just re-encode on the fly, so the action would
            # silently do nothing.  Say so loudly instead.
            log.warning("'encode' action requested without a cache path -- "
                        "skipping bulk encoding (pass --cache to persist "
                        "encodings; scoring will encode on the fly)")
    for facet in facets:
        if "score" in actions:
            score_dataset(model, dataset, results_dir, facet=facet)
        if "evaluate" in actions:
            out[facet or "all"] = evaluate_scores(results_dir, dataset, facet=facet)
    if dataset.name == "csfcube" and "evaluate" in actions and set(facets) >= set(FACETS):
        out["all"] = aggregate_all_facets(results_dir, dataset)
    return out


def aggregate_all_facets(results_dir: str, dataset: EvalDataset) -> dict:
    """CSFCube 'all' aggregate: cross-val over the union of faceted queries."""
    gold_metrics = {}
    for facet in FACETS:
        gold = dataset.get_gold_test_data(facet=facet)
        with codecs.open(scores_filename(results_dir, facet), "r", "utf-8") as f:
            scores = json.load(f)
        ranked = {q: [(c, s) for c, s in v] for q, v in scores.items()}
        rels = ranked_relevances(ranked, gold)
        qm = per_query_metrics(rels, threshold_grade=dataset.get_threshold_grade())
        gold_metrics.update({f"{q}_{facet}": m for q, m in qm.items()})
    return {split: aggregate_crossval(gold_metrics, "all", split)
            for split in ("dev", "test")}
