"""Inputs drawn from a run's seed: tokenised abstracts, an int8 multi-vector
index and a bf16 bucket laid out as `index.dense` keeps them, query pools.

The same seed gives the same inputs.  Each kind of input takes its own
stream (`sub_seed(seed, tag)`), so that adding one never moves another.
Large arrays are drawn on the device with a `torch.Generator`, in few calls.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

CLS, SEP, PAD, FIRST_WORD = 102, 103, 0, 105   # scivocab's special ids
CHUNK_ROWS = 1 << 14                            # document rows drawn a call


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each kind of input."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def sentence_counts(rng: np.random.Generator, n: int, spec: dict) -> np.ndarray:
    """clip(poisson(mean), lo, hi) sentences a document."""
    return np.clip(rng.poisson(spec["mean"], n), spec["min"], spec["max"])


# ---------------------------------------------------------------- abstracts
def abstracts(seed: int, tag: str, n_docs: int, traffic: dict, vocab: int,
              max_sents: int) -> dict:
    """n_docs tokenised abstracts of `traffic["seq"]` tokens:
    [CLS] sentence ... sentence [SEP] [PAD]..., sentences of
    `traffic["sentence_tokens"]` tokens drawn uniformly, a document's count
    of sentences from `traffic["sentences"]`; a sentence that would not fit
    whole is dropped, as are sentences past `max_sents`.

    -> numpy arrays token_ids int64 [n, seq], attn_mask int64 [n, seq],
    sent_ids int64 [n, seq] (-1 off the sentences), lens int32 [n]
    (sentences kept), tokens int32 [n] (real tokens)."""
    rng = np.random.default_rng(sub_seed(seed, tag))
    seq = traffic["seq"]
    lo, hi = traffic["sentence_tokens"]
    counts = sentence_counts(rng, n_docs, traffic["sentences"])
    ids = np.full((n_docs, seq), PAD, np.int64)
    mask = np.zeros((n_docs, seq), np.int64)
    sent = np.full((n_docs, seq), -1, np.int64)
    lens = np.zeros(n_docs, np.int32)
    tokens = np.zeros(n_docs, np.int32)
    words = rng.integers(FIRST_WORD, vocab, (n_docs, seq))
    for i in range(n_docs):
        sizes = rng.integers(lo, hi + 1, counts[i])
        pos, kept = 1, 0
        for size in sizes:
            if pos + size + 1 > seq or kept == max_sents:
                break
            sent[i, pos:pos + size] = kept
            pos += size
            kept += 1
        ids[i, 1:pos] = words[i, 1:pos]
        ids[i, 0], ids[i, pos] = CLS, SEP
        mask[i, :pos + 1] = 1
        lens[i], tokens[i] = kept, pos + 1
    return {"token_ids": ids, "attn_mask": mask, "sent_ids": sent,
            "lens": lens, "tokens": tokens}


# -------------------------------------------------------------------- index
def int8_index(seed: int, n_docs: int, spec: dict, dim: int, device) -> dict:
    """A multi-vector int8 index of n_docs documents, clip(poisson) sentences
    each, in dense buckets of `spec["buckets"]` sentences (a document goes to
    the smallest that holds it, rows padded to a multiple of 8): the arrays
    `DenseBucketIndex.device_arrays()` and `.device_pos_arrays()` give.

    A stored sentence is int8 values x_i8 = clip(round(32 z), -127, 127),
    z ~ N(0, 1), with a scale u / 32, u ~ U(0.5, 1.5): the dequantised
    sentence is about u z.  The int8 values and the scales are the index as
    stored; its norms are derived from them here, as the index build derives
    them (|stored|^2 = scale^2 sum x_i8^2), +inf at pad slots.

    -> {"lens": int32[n_docs] (device), "buckets": [{"sents", "norms",
    "doc_idx", "scales"}], "pos": (doc_bucket, doc_row, doc_lens)}."""
    rng = np.random.default_rng(sub_seed(seed, "index-lens"))
    lens_np = sentence_counts(rng, n_docs, spec["sentences"]).astype(np.int32)
    gen = generator(seed, "index-values", device)
    sizes = spec["buckets"]
    if lens_np.max() > sizes[-1]:
        raise ValueError(f"documents of {lens_np.max()} sentences exceed the "
                         f"largest bucket, {sizes[-1]}")
    lens = torch.from_numpy(lens_np).to(device)
    doc_bucket = torch.full((n_docs,), -1, dtype=torch.int32, device=device)
    doc_row = torch.zeros(n_docs, dtype=torch.int32, device=device)
    buckets, lower = [], 0
    for s in sizes:
        member = (lens > lower) & (lens <= s)
        docs = torch.nonzero(member).flatten().to(torch.int32)
        lower = s
        if docs.numel() == 0:
            continue
        n = -(-docs.numel() // 8) * 8
        doc_bucket[docs.long()] = len(buckets)
        doc_row[docs.long()] = torch.arange(docs.numel(), dtype=torch.int32,
                                            device=device)
        doc_idx = torch.full((n,), -1, dtype=torch.int32, device=device)
        doc_idx[:docs.numel()] = docs
        row_lens = torch.zeros(n, dtype=torch.int32, device=device)
        row_lens[:docs.numel()] = lens[docs.long()]
        sents = torch.empty((n, s, dim), dtype=torch.int8, device=device)
        scales = torch.empty((n, s), dtype=torch.float32, device=device)
        norms = torch.empty((n, s), dtype=torch.float32, device=device)
        for i in range(0, n, CHUNK_ROWS):
            rows = slice(i, min(i + CHUNK_ROWS, n))
            z = torch.randn((rows.stop - i, s, dim), generator=gen,
                            device=device)
            live = (torch.arange(s, device=device)[None, :]
                    < row_lens[rows, None])                      # [r, s]
            xi = torch.clamp(torch.round(z * 32.0), -127, 127)
            xi = xi * live[:, :, None]
            u = torch.rand((rows.stop - i, s), generator=gen, device=device)
            sc = torch.where(live, (u + 0.5) / 32.0, torch.zeros_like(u))
            sents[rows] = xi.to(torch.int8)
            scales[rows] = sc
            sq = (xi * xi).sum(-1)
            norms[rows] = torch.where(live, sq * sc * sc,
                                      torch.full_like(sq, float("inf")))
            del z, xi
        buckets.append({"sents": sents, "norms": norms, "doc_idx": doc_idx,
                        "scales": scales})
    return {"lens": lens, "buckets": buckets,
            "pos": (doc_bucket, doc_row, lens.clone())}


def bf16_bucket(seed: int, n_docs: int, s: int, dim: int, device) -> dict:
    """One dense bf16 bucket of n_docs documents of s sentences, N(0, 1)
    entries, as `benchmarks/torch_pool_bench.synth_bucket` lays it out."""
    gen = generator(seed, "bucket-values", device)
    sents = torch.randn((n_docs, s, dim), generator=gen, device=device,
                        dtype=torch.bfloat16)
    norms = torch.empty((n_docs, s), dtype=torch.float32, device=device)
    for i in range(0, n_docs, 8192):
        norms[i:i + 8192] = sents[i:i + 8192].float().square().sum(-1)
    doc_idx = torch.arange(n_docs, dtype=torch.int32, device=device)
    pos = (torch.zeros(n_docs, dtype=torch.int32, device=device),
           doc_idx.clone(),
           torch.full((n_docs,), s, dtype=torch.int32, device=device))
    return {"buckets": [{"sents": sents, "norms": norms, "doc_idx": doc_idx}],
            "pos": pos, "lens": pos[2]}


def pools(seed: int, tag: str, n_queries: int, traffic: dict, n_docs: int,
          dim: int, device) -> dict:
    """Query reps N(0, 1) of `traffic["query_sents"]` sentences and pools
    of `traffic["pool"]` candidate ids, distinct within a pool, the first
    U[pool_live_min, pool] of them live and the rest pad (-1)."""
    gen = generator(seed, tag, device)
    qn, pool = traffic["query_sents"], traffic["pool"]
    q = torch.randn((n_queries, qn, dim), generator=gen, device=device)
    q_lens = torch.full((n_queries,), qn, dtype=torch.int32, device=device)
    keys = torch.rand((n_queries, n_docs), generator=gen, device=device)
    cand = torch.topk(keys, pool, dim=1).indices.to(torch.int32)
    live = torch.randint(traffic["pool_live_min"], pool + 1, (n_queries,),
                         generator=gen, device=device)
    cand = torch.where(torch.arange(pool, device=device)[None, :] < live[:, None],
                       cand, torch.full_like(cand, -1))
    return {"q": q, "q_lens": q_lens, "cand_ids": cand}
