"""The 1M-document shard merge of the port: one int8 index searched by shard
ranks and by one device, with the same ids and scores (counterpart of
scripts/serve_1m_mesh.py).

The index is scripts/serve_1m_mesh.py's: 1,000,000 documents of
clip(poisson(9), 3, 20) sentences of 768-d standard normal reps times 2
(numpy seed 0, one document after another), int8 with per-sentence scales,
buckets (12, 24), packed for 8 shards; queries of 10 sentences padded to 16.
The host quantises each document as it is drawn (what
build_dense_index(dtype="int8") computes; the f32 reps of the whole corpus
would be 27 GB), saves the index once, and each rank maps the files and puts
its slice of every bucket on its device (`device_arrays(mesh=)`).  The ranks
search through `make_dense_search(mesh=)` -- the scan kernels on CUDA, each
rank's top-k merged by one all_gather -- then this process searches the
whole index on one device; scores must agree within 1e-5, ids where a
score stands more than 1e-4 apart from its neighbours (the two routes'
products may round a near tie either way).

    python scripts/torch_serve_1m_mesh.py --ranks 4              # 4 cards, nccl
    python scripts/torch_serve_1m_mesh.py --ranks 4 --colocate   # gloo ranks on cuda:0
    python scripts/torch_serve_1m_mesh.py --docs 3000 --ranks 2 --device cpu
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

D, Q_SENTS, Q_PAD = 768, 10, 16


def build(n_docs: int, n_queries: int):
    """(prequantised int8 index, queries [n, 16, 768]) from numpy seed 0."""
    import numpy as np

    from aspire_tpu_torch.index.dense import build_dense_index_prequantized

    rng = np.random.default_rng(0)
    lens = np.clip(rng.poisson(9, n_docs), 3, 20)
    docs = []
    for n in lens:
        x = rng.standard_normal((n, D), dtype=np.float32) * 2
        sc = np.abs(x).max(axis=1) / np.float32(127.0)
        sc = np.where(sc > 0, sc, 1.0).astype(np.float32)
        xi = np.clip(np.rint(x / sc[:, None]), -127, 127).astype(np.int8)
        docs.append((xi, sc))
    idx = build_dense_index_prequantized(docs, [f"p{i}" for i in range(n_docs)],
                                         buckets=(12, 24), n_shards=8)
    qs = np.pad(rng.standard_normal((n_queries, Q_SENTS, D)).astype(np.float32)
                * 2, ((0, 0), (0, Q_PAD - Q_SENTS), (0, 0)))
    return idx, qs


def _search_all(search, flat, qs, device):
    import torch
    out, ms = [], []
    for q in qs:
        q = torch.from_numpy(q).to(device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, d = search(q, Q_SENTS, *flat)
        v, d = v.cpu().numpy(), d.cpu().numpy()
        ms.append((time.perf_counter() - t0) * 1e3)
        out.append((v, d))
    return out, ms


def _rank(index_dir: str, qs, k: int):
    from aspire_tpu_torch.index.dense import (DenseBucketIndex,
                                              flatten_device_buckets,
                                              make_dense_search)
    from aspire_tpu_torch.parallel.mesh import make_serving_mesh

    mesh = make_serving_mesh()
    idx = DenseBucketIndex.load(index_dir, mmap=True)
    flat = flatten_device_buckets(idx.device_arrays(mesh=mesh))
    search = make_dense_search(len(idx.buckets), k=k, int8=True, mesh=mesh)
    _search_all(search, flat, qs[:1], mesh.device)          # warm-up
    results, ms = _search_all(search, flat, qs, mesh.device)
    return {"results": results, "ms": ms, "device": str(mesh.device),
            "backend": mesh.backend}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=4)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--ranks", type=int, default=4,
                    help="shard ranks (one a card over nccl on CUDA)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--colocate", action="store_true",
                    help="every rank on cuda:0 over gloo (one card)")
    args = ap.parse_args()

    import numpy as np
    import torch

    from aspire_tpu_torch.core.types import require_device
    from aspire_tpu_torch.index.dense import (flatten_device_buckets,
                                              make_dense_search)
    from aspire_tpu_torch.parallel.mesh import run_ranks

    device = require_device(args.device)
    t0 = time.perf_counter()
    idx, qs = build(args.docs, args.queries)
    gb = sum(b["sents"].nbytes + b["norms"].nbytes + b["scales"].nbytes
             for b in idx.buckets) / 1e9
    print(json.dumps({"index": {"docs": args.docs, "gb_int8": gb,
                                "build_s": time.perf_counter() - t0}}),
          flush=True)
    with tempfile.TemporaryDirectory(prefix="aspire_1m_") as tmp:
        idx.save(tmp)
        ranks = run_ranks(_rank, args.ranks, tmp, qs, args.k, device=device,
                          backend="gloo" if args.colocate else None,
                          colocate=args.colocate)
    flat = flatten_device_buckets(idx.device_arrays(device))
    search = make_dense_search(len(idx.buckets), k=args.k, int8=True)
    _search_all(search, flat, qs[:1], device)
    single, single_ms = _search_all(search, flat, qs, device)
    for r in ranks:
        for (v, d), (v1, d1) in zip(r["results"], single):
            np.testing.assert_allclose(v, v1, rtol=1e-5, atol=1e-5)
            # equal scores may order differently across the merge: ids are
            # held where a score stands apart from its neighbours
            apart = np.ones(len(v1), bool)
            gaps = np.abs(np.diff(v1)) > 1e-4
            apart[1:] &= gaps
            apart[:-1] &= gaps
            np.testing.assert_array_equal(d[apart], d1[apart])
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(json.dumps({"merge_1m": "ok", "ranks": args.ranks,
                      "backend": ranks[0]["backend"],
                      "rank_devices": [r["device"] for r in ranks],
                      "sharded_ms": ranks[0]["ms"], "single_ms": single_ms,
                      "device": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
