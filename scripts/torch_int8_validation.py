"""Re-validate the int8 serving recipe on ENCODER-produced representations,
with the PyTorch/CUDA port (the port's copy of scripts/int8_validation.py;
the same flags and the same JSON summary).

Containment of the exact top-50 in the int8 top-64 was first measured on
isotropic Gaussians; an encoder's reps are anisotropic with smaller relative
score gaps, so it is measured here on reps an encoder produced:

  1. encodes a corpus of abstracts with the port's `encode_corpus` (bf16,
     max 24 sentences): a ConSentEncoder from a trained run directory
     (--run-dir, the port's `model_cur_best.pt`) or a random-init BERT-base
     (--random-bert: weights from a seeded torch.Generator; untrained BERT
     reps are anisotropic) -- or takes the reps of an f32 index
     (--from-index);
  2. builds f32 (ground truth), bf16 and int8 dense-bucket indexes
     (index/dense.build_dense_index) from the same reps;
  3. searches held-out documents as single queries (make_dense_search: the
     scan kernels on the GPU -- bf16 and int8 rows, and f32) and measures
       - exact (f32) top-50 containment within the int8 top-M at each margin,
       - top-1 agreement int8 vs f32,
       - bf16-storage top-50 vs f32 top-50 overlap,
       - the final top-k after the exact OT rerank (index/serve.ot_rerank:
         the Sinkhorn kernel on the GPU) of each recipe's stage-1 pool;
  4. prints one JSON summary line.

Usage:
  python scripts/torch_int8_validation.py --abstracts abstracts-0.jsonl \\
      --random-bert --tokenizer VOCAB_DIR --n-docs 4000
  python scripts/torch_int8_validation.py --from-index INDEX_DIR --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--abstracts", nargs="+", default=[],
                    help="abstracts jsonl file(s): {paper_id,title,abstract}")
    ap.add_argument("--from-index",
                    help="skip encoding: take encoder reps from an existing "
                         "f32 DenseBucketIndex directory (e.g. one built by "
                         "`build-index` without --bf16/--int8)")
    ap.add_argument("--run-dir")
    ap.add_argument("--random-bert", action="store_true")
    ap.add_argument("--tokenizer", help="a local vocab.txt directory "
                                        "(required unless --from-index)")
    ap.add_argument("--n-docs", type=int, default=4000)
    ap.add_argument("--n-queries", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=512,
                    help="tokens a document in the encode")
    ap.add_argument("--k-exact", type=int, default=50)
    ap.add_argument("--k-int8", type=int, default=64)
    ap.add_argument("--margins", default="64,96,128,192,256",
                    help="int8 stage-1 depths to test containment/rerank at")
    ap.add_argument("--final-k", type=int, default=10,
                    help="final reranked depth compared across recipes")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def encoder(args, device):
    """A bf16 ConSentEncoder (24 sentences): random BERT-base or a run's."""
    from aspire_tpu_torch.models.bert import BertConfig
    from aspire_tpu_torch.models.encoders import ConSentEncoder
    if args.random_bert:
        enc = ConSentEncoder(BertConfig(), max_sents=24, dtype=torch.bfloat16,
                             device=device)
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for name, p in enc.named_parameters():
                if "LayerNorm" in name:
                    p.fill_(1.0 if name.endswith("weight") else 0.0)
                else:
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        return enc
    if not args.run_dir:
        raise SystemExit("--run-dir or --random-bert required")
    from aspire_tpu_torch.evaluation.models import _run_info, _sub_state
    _, cfg, sd = _run_info(args.run_dir, "cur_best")
    enc = ConSentEncoder(cfg, max_sents=24, dtype=torch.bfloat16, device=device)
    enc.bert.load_state_dict(_sub_state(sd, "encoder.bert."))
    return enc


def encode_docs(args, docs, device) -> list:
    from aspire_tpu_torch.index.build import encode_corpus
    from aspire_tpu_torch.text.fast import FastWordPiece
    tok = FastWordPiece.from_dir(args.tokenizer)
    reps, _ = encode_corpus(encoder(args, device), docs, tok,
                            batch_size=args.batch_size, seq_len=args.seq_len,
                            max_sents=24)
    return reps


def reps_from_index(args) -> list:
    from aspire_tpu_torch.index.dense import DenseBucketIndex
    idx0 = DenseBucketIndex.load(args.from_index)
    assert not idx0.is_int8 and idx0.sent_dtype == "float32", \
        "--from-index needs f32 storage"
    idx0._ensure_doc_pos()
    n = min(idx0.n_docs, args.n_docs + args.n_queries)
    reps = []
    for di in range(n):
        b = idx0.buckets[idx0._doc_bucket[di]]
        reps.append(np.asarray(b["sents"][idx0._doc_row[di], : idx0.doc_lens[di]],
                               np.float32))
    print(f"loaded {len(reps)} docs' reps from {args.from_index}", flush=True)
    return reps


def read_docs(args) -> list:
    docs = []
    for path in args.abstracts:
        with open(path) as f:
            for line in f:
                d = json.loads(line)
                docs.append({"TITLE": d["title"], "ABSTRACT": d["abstract"]})
                if len(docs) >= args.n_docs + args.n_queries:
                    return docs
    return docs


def main(argv=None) -> dict:
    from aspire_tpu_torch.core.types import MultiVec, require_device
    from aspire_tpu_torch.index.dense import (build_dense_index,
                                              flatten_device_buckets,
                                              make_dense_search)
    from aspire_tpu_torch.index.serve import ot_rerank

    args = parse_args(argv)
    device = require_device(args.device)
    if args.from_index:
        reps = reps_from_index(args)
    else:
        docs = read_docs(args)
        assert len(docs) > args.n_queries, f"only {len(docs)} docs loaded"
        print(f"encoding {len(docs)} docs "
              f"({'random-bert' if args.random_bert else args.run_dir})",
              flush=True)
        reps = encode_docs(args, docs, device)

    q_reps, c_reps = reps[: args.n_queries], reps[args.n_queries:]
    pids = [f"p{i}" for i in range(len(c_reps))]
    # anisotropy diagnostic: mean pairwise cosine of sentence reps (isotropic
    # Gaussians ~0; BERT-ish encoders are typically >>0)
    flat = np.concatenate([r for r in c_reps[:500]], axis=0)
    flat = flat / np.maximum(np.linalg.norm(flat, axis=1, keepdims=True), 1e-9)
    mu = flat.mean(axis=0)
    anis = float(np.dot(mu, mu))

    margins = [int(m) for m in args.margins.split(",")]
    k_deep = max(margins)
    tops = {}
    for storage, label in (("float32", "f32"), ("bfloat16", "bf16"),
                           ("int8", "int8")):
        idx = build_dense_index(c_reps, pids, dtype=storage)
        fl = flatten_device_buckets(idx.device_arrays(device))
        k = args.k_exact if label == "bf16" else k_deep
        search = make_dense_search(len(idx.buckets), k=k, int8=idx.is_int8)
        per_q = []
        for q in q_reps:
            qmax = -(-len(q) // 8) * 8
            qp = np.zeros((qmax, q.shape[1]), np.float32)
            qp[: len(q)] = q
            with torch.no_grad():
                _, docs_i = search(torch.from_numpy(qp).to(device), len(q), *fl)
            per_q.append(docs_i.cpu().numpy())
        tops[label] = per_q
        del fl

    contain = {m: [len(set(e[: args.k_exact]) & set(i8[:m])) / args.k_exact
                   for e, i8 in zip(tops["f32"], tops["int8"])]
               for m in margins}
    top1 = [int(e[0] == i8[0]) for e, i8 in zip(tops["f32"], tops["int8"])]
    bf16_overlap = [len(set(e[: args.k_exact]) & set(b[: args.k_exact]))
                    / args.k_exact
                    for e, b in zip(tops["f32"], tops["bf16"])]

    # The metric that decides the recipe: FINAL top-k after the exact OT
    # rerank (candidates' true f32 reps), int8 stage 1 at margin m vs f32
    # stage 1 -- stage-1 containment misses are harmless iff the final
    # reranked results agree.
    def padded_reps(ids):
        smax = 20
        out = np.zeros((len(ids), smax, c_reps[0].shape[1]), np.float32)
        lens = np.zeros((len(ids),), np.int32)
        for j, di in enumerate(ids):
            r = c_reps[di][:smax]
            out[j, : len(r)] = r
            lens[j] = len(r)
        return MultiVec(embed=torch.from_numpy(out).to(device),
                        lens=torch.from_numpy(lens).to(device))

    def rerank_top(q, cand_ids, kf):
        cands = padded_reps(cand_ids)
        qmax = 20
        qp = np.zeros((1, qmax, q.shape[1]), np.float32)
        qp[0, : len(q)] = q[:qmax]
        qmv = MultiVec(embed=torch.from_numpy(qp).to(device),
                       lens=torch.tensor([min(len(q), qmax)], dtype=torch.int32,
                                         device=device))
        sims = ot_rerank(qmv, cands, temp=5000.0).cpu().numpy()
        order = np.argsort(-sims)[:kf]
        return [cand_ids[j] for j in order]

    # int8 vs f32 at the SAME stage-1 depth m isolates quantization; the
    # depth-sensitivity row isolates how much the final top-k moves when the
    # EXACT pipeline widens its own stage-1 pool.
    final_agree = {}
    for m in margins:
        agree = []
        for qi, q in enumerate(q_reps):
            ref_final = rerank_top(q, list(tops["f32"][qi][:m]), args.final_k)
            i8_final = rerank_top(q, list(tops["int8"][qi][:m]), args.final_k)
            agree.append(len(set(ref_final) & set(i8_final)) / args.final_k)
        final_agree[m] = round(float(np.mean(agree)), 4)
    depth_sense = {}
    for m in margins[1:]:
        agree = []
        for qi, q in enumerate(q_reps):
            shallow = rerank_top(q, list(tops["f32"][qi][: margins[0]]),
                                 args.final_k)
            deep = rerank_top(q, list(tops["f32"][qi][:m]), args.final_k)
            agree.append(len(set(shallow) & set(deep)) / args.final_k)
        depth_sense[m] = round(float(np.mean(agree)), 4)

    summary = {
        "metric": "int8_recipe_on_encoder_reps",
        "encoder": "random-bert" if args.random_bert else args.run_dir,
        "n_docs": len(c_reps), "n_queries": len(q_reps),
        "anisotropy_mean_cos": round(anis, 4),
        "containment_top50_in_int8_topM":
            {m: round(float(np.mean(v)), 4) for m, v in contain.items()},
        "containment_min_topM":
            {m: round(float(np.min(v)), 4) for m, v in contain.items()},
        "top1_agreement_int8_stage1": round(float(np.mean(top1)), 4),
        "bf16_top50_overlap": round(float(np.mean(bf16_overlap)), 4),
        "final_top%d_agreement_after_exact_rerank" % args.final_k: final_agree,
        "f32_pipeline_depth_sensitivity_vs_top%d" % margins[0]: depth_sense,
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
