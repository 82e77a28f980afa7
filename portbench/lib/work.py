"""The work an algorithm needs for given shapes: operations and bytes, counted
from the shapes the benchmark drew, never from what a kernel happens to do.

Operations count only real elements (tokens of a document, sentences of a
query or a document, atoms with mass), so a kernel that computes padding gets
no credit for it.  Bytes count each input array once as the entry receives it
(padding included: that is the layout it is handed) and each output once.

Each call of a cell's entry is described by a plain dict (`kinds/*.py` make
them for the calls the profiler saw):

  encoder: {"tokens": [real tokens a document], "seq": padded length,
            "layers", "hidden", "ffn", "heads"}
  scan:    {"q_sents": [real sentences a query], "qmax", "dim",
            "buckets": [[rows, sentences a row], ...], "doc_sents": real
            document sentences in the index}
  rerank:  {"n": [real query atoms a pair], "m": [real candidate atoms a
            pair], "n_pad", "m_pad", "iters": [schedule length a pair],
            "dim"}
"""
from __future__ import annotations

import math

import numpy as np

from .peaks import (PEAK_BF16, PEAK_F32_PRODUCT, PEAK_SFU, least_seconds)

BF16_BYTES, F32_BYTES = 2, 4


# ------------------------------------------------------------------ encoder
def encoder_linear_ops(w: dict) -> float:
    """Q, K, V, the attention output and the two FFN products, every layer,
    over the real tokens."""
    t = float(np.sum(w["tokens"]))
    h, f = w["hidden"], w["ffn"]
    return w["layers"] * 2.0 * t * (4 * h * h + 2 * h * f)


def encoder_attention_ops(w: dict) -> float:
    """q.k and p.v over each document's real tokens, every layer."""
    t2 = float(np.sum(np.square(np.asarray(w["tokens"], np.float64))))
    return w["layers"] * 4.0 * t2 * w["hidden"]


def encoder_seconds(w: dict) -> float:
    """The least time of an encode's products on the bf16 tensor cores."""
    return (encoder_linear_ops(w) + encoder_attention_ops(w)) / PEAK_BF16


def ffn_bytes(w: dict) -> float:
    """One layer's FFN call: x and out [rows, h] bf16 as handed over (padded
    rows included), both weights and biases in bf16."""
    rows = len(w["tokens"]) * w["seq"]
    h, f = w["hidden"], w["ffn"]
    return BF16_BYTES * (2 * rows * h + 2 * h * f + h + f)


def ffn_ops(w: dict) -> float:
    return 4.0 * float(np.sum(w["tokens"])) * w["hidden"] * w["ffn"]


def attention_bytes(w: dict) -> float:
    """One layer's attention forward: q, k, v and the context, bf16
    [b, heads, seq, hidden / heads] each, and the f32 key mask [b, seq]."""
    b, t, h = len(w["tokens"]), w["seq"], w["hidden"]
    return 4 * BF16_BYTES * b * t * h + F32_BYTES * b * t


def attention_ops(w: dict) -> float:
    t2 = float(np.sum(np.square(np.asarray(w["tokens"], np.float64))))
    return 4.0 * t2 * w["hidden"]


# --------------------------------------------------------------------- scan
def scan_bytes(w: dict) -> float:
    """The int8 rows with their f32 norms and scales, the f32 query and the
    f32 per-document scores of each query."""
    d, bsz = w["dim"], len(w["q_sents"])
    rows = sum(n * s for n, s in w["buckets"])
    docs = sum(n for n, _ in w["buckets"])
    return rows * (d + 2 * F32_BYTES) + F32_BYTES * bsz * (w["qmax"] * d + docs)


def scan_ops(w: dict) -> float:
    """2 q.x for every real query sentence against every real document
    sentence."""
    return 2.0 * float(np.sum(w["q_sents"])) * w["doc_sents"] * w["dim"]


def scan_seconds(w: dict) -> float:
    # the query is bf16 and the int8 rows are exact in bf16: the product is
    # a bf16 one (an int8 product would need a quantised query)
    return least_seconds(scan_bytes(w), scan_ops(w), PEAK_BF16)


# ------------------------------------------------------------------- rerank
def sinkhorn_terms(w: dict) -> float:
    """exp and log calls of the log-domain solve over the real atoms: each
    round (the first, the schedule's, the final step) takes two
    exponentials a cell and a log an atom."""
    n, m = np.asarray(w["n"], np.float64), np.asarray(w["m"], np.float64)
    rounds = np.asarray(w["iters"], np.float64) + 2.0
    return float(np.sum(rounds * (2.0 * n * m + n + m)))


def sinkhorn_bytes(w: dict) -> float:
    """The f32 cost [n_pad, m_pad], both log-weights, the diameter and both
    potentials of every pair, as the solver is handed them."""
    p = len(w["n"])
    n, m = w["n_pad"], w["m_pad"]
    return F32_BYTES * p * (n * m + 2 * (n + m) + 1)


def sinkhorn_seconds(w: dict) -> float:
    return least_seconds(sinkhorn_bytes(w), sinkhorn_terms(w), PEAK_SFU)


def cost_ops(w: dict) -> float:
    """q.c of the ground cost over the real atoms of every pair."""
    n, m = np.asarray(w["n"], np.float64), np.asarray(w["m"], np.float64)
    return 2.0 * float(np.sum(n * m)) * w["dim"]


def rerank_seconds(w: dict) -> float:
    """The cost's f32-accurate product plus the solve's special functions."""
    return cost_ops(w) / PEAK_F32_PRODUCT + sinkhorn_terms(w) / PEAK_SFU


def schedule_len(diam, blur: float, scaling: float, max_iters: int):
    """Annealing rounds a pair runs: len of geomloss's epsilon list, capped
    as the solvers cap it."""
    diam = np.maximum(np.asarray(diam, np.float64), 1e-30)
    k = np.ceil(np.maximum(np.log(blur / diam) / math.log(scaling), 0.0))
    return np.minimum(k + 2.0, max_iters)
