#!/usr/bin/env python3
"""Deep-pool scoring on one GPU, TRECCOVID-RF-shaped pools: the port's twin of benchmarks/pool_bench.py.

    python3 benchmarks/torch_pool_bench.py [--n-docs 100000] [--pool 2048]
        [--batch 8] [--sents 12] [--max-sents 24] [--qmax 16] [--iters 64]
        [--solver kernel|torch] [--profile]                       # needs one GPU
    python3 benchmarks/torch_pool_bench.py --device cpu --n-docs 200 --pool 16 \
        --batch 2 --iters 2                                       # the code path only

The reference's deepest pools are TRECCOVID-RF's (up to about 2,000
candidates a query).  Four rows, as pool_bench.py prints them:

  * pool_rank_l2max, pool_rank_ot: the serving pool path,
    `index.serve.make_pool_rank_batched(1, pool_size, max_sents, agg,
    temp=5000)`: the candidates gathered on the card from a dense bucket by
    document id, then each pool scored by l2max or by Sinkhorn OT with a
    diameter a pair.  The gathered f32 block is kept under 1 GiB
    (`index.serve.GATHER_BYTES`): at the defaults 7 queries a chunk, so an OT
    call makes two solves, of 7 x 2,048 and 1 x 2,048 pairs of 16 x 24;
  * score_chunk_l2max, score_chunk_ot: the evaluation ladder's chunk of
    1,024 pairs at smax --max-sents, `wasserstein_dist(diameter="pair",
    return_pair_sims=True)` and `l2max_dist`; a pool of P costs
    ceil(P / 1024) chunks.

The corpus is one dense bf16 bucket of --n-docs documents of --sents
sentences, drawn on the card from a seeded `torch.Generator` in the layout
`index.dense` keeps (sents, norms, doc_idx; doc_bucket, doc_row, doc_lens):
at the defaults 100,000 x 12 x 768, 1.84 GB.  The gather and the scoring do
not depend on the values.  pool_bench.py draws with `jax.random`; these are
other values of the same shapes and distributions.

Timing: CUDA events around --iters back-to-back calls after two warm-up
calls.  Each row is preceded by a line of the K1 launches a call (from the
kernel's counters).  The first line is the card's name and power limit.  On
the CPU (`--device cpu`, for the tests) the rows' times are null: a CPU run
measures no card.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys

import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

from aspire_tpu_torch.core.types import MultiVec, require_device  # noqa: E402
from aspire_tpu_torch.index.serve import make_pool_rank_batched  # noqa: E402
from aspire_tpu_torch.ops.distances import l2max_dist, wasserstein_dist  # noqa: E402
from torch_bench import card, k1_launches, ms_a_call  # noqa: E402

DIM = 768
CHUNK = 1024               # the evaluation ladder's pairs a chunk


def synth_bucket(n_docs: int, s: int, seed: int, device) -> tuple:
    """One dense bf16 bucket and its position arrays, drawn on `device`:
    (flat = (sents bf16[n, s, 768], norms f32[n, s], doc_idx int32[n]),
     pos = (doc_bucket, doc_row, doc_lens), int32[n] each)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sents = torch.randn((n_docs, s, DIM), generator=gen, device=device,
                        dtype=torch.bfloat16)
    norms = torch.empty((n_docs, s), dtype=torch.float32, device=device)
    for i in range(0, n_docs, 8192):             # f32 squares a slice at a time
        norms[i:i + 8192] = sents[i:i + 8192].float().square().sum(-1)
    doc_idx = torch.arange(n_docs, dtype=torch.int32, device=device)
    pos = (torch.zeros(n_docs, dtype=torch.int32, device=device), doc_idx.clone(),
           torch.full((n_docs,), s, dtype=torch.int32, device=device))
    return (sents, norms, doc_idx), pos


def pool_queries(batch: int, qmax: int, pool: int, n_docs: int, seed: int,
                 device) -> tuple:
    """(q f32[batch, qmax, 768], q_lens int32[batch] (all qmax),
    cand_ids int32[batch, pool] drawn from [0, n_docs))."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((batch, qmax, DIM), generator=gen, device=device)
    q_lens = torch.full((batch,), qmax, dtype=torch.int32, device=device)
    cand = torch.randint(0, n_docs, (batch, pool), generator=gen, device=device,
                         dtype=torch.int32)
    return q, q_lens, cand


def chunk_pairs(smax: int, sents: int, seed: int, device) -> tuple:
    """The ladder's chunk: two MultiVecs of [1024, smax, 768] reps N(0, 1),
    lens `sents`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    lens = torch.full((CHUNK,), sents, dtype=torch.int32, device=device)
    return tuple(MultiVec(torch.randn((CHUNK, smax, DIM), generator=gen,
                                      device=device), lens) for _ in range(2))


def pool_ranker(pool: int, max_sents: int, agg: str, solver: str):
    """The serving pool path over one bucket at temp 5000."""
    return make_pool_rank_batched(1, pool_size=pool, max_sents=max_sents, agg=agg,
                                  temp=5000.0, solver=solver)


def chunk_scorer(agg: str, solver: str):
    def run(qm: MultiVec, cm: MultiVec) -> torch.Tensor:
        with torch.no_grad():
            if agg == "ot":
                s, _ = wasserstein_dist(qm, cm, temp=5000.0, return_pair_sims=True,
                                        diameter="pair", solver=solver)
            else:
                s, _ = l2max_dist(qm, cm, return_pair_sims=True)
        return s
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-docs", type=int, default=100_000)
    ap.add_argument("--pool", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--sents", type=int, default=12)
    ap.add_argument("--max-sents", type=int, default=24)
    ap.add_argument("--qmax", type=int, default=16)
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--solver", choices=["kernel", "torch"], default="kernel")
    ap.add_argument("--profile", action="store_true",
                    help="also profile the OT pool call and the OT chunk")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the code path, no metric)")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    on_card = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    if on_card:
        print(card(), flush=True)
    flat, pos = synth_bucket(args.n_docs, args.sents, 0, dev)
    B, P = args.batch, args.pool
    q, q_lens, cand_ids = pool_queries(B, args.qmax, P, args.n_docs, 1, dev)

    def timed(label: str, fn) -> float | None:
        before = k1_launches()
        ms = ms_a_call(fn, args.iters, 2, dev)
        print(json.dumps({"of": label, "k1_launches_a_call":
                          (k1_launches() - before) / (args.iters + 2)}), flush=True)
        if args.profile and on_card and label.endswith("ot"):
            from torch_index_profile import profiled
            profiled(label, fn, 5, 12)
        return ms / 1e3 if on_card else None

    def rate(n: float, dt: float | None, digits: int = 1):
        return None if dt is None else round(n / dt, digits)

    def ms(dt: float | None, times: float = 1.0):
        return None if dt is None else round(dt * times * 1e3, 3)

    for agg in ("l2max", "ot"):
        fn = pool_ranker(P, args.max_sents, agg, args.solver)
        dt = timed(f"pool_rank_{agg}",
                   lambda: fn(q, q_lens, cand_ids, *flat, *pos))
        print(json.dumps({
            "metric": f"pool_rank_{agg}", "path": "serving-pool",
            "n_docs": args.n_docs, "pool": P, "batch": B,
            "solver": args.solver if agg == "ot" else "n/a",
            "ms_per_query": ms(dt, 1.0 / B),
            "queries_per_sec": rate(B, dt),
            "pairs_per_sec": rate(B * P, dt),
        }), flush=True)

    qm, cm = chunk_pairs(args.max_sents, args.sents, 2, dev)
    n_chunks = math.ceil(P / CHUNK)
    for agg in ("l2max", "ot"):
        fn = chunk_scorer(agg, args.solver)
        dt = timed(f"score_chunk_{agg}", lambda: fn(qm, cm))
        print(json.dumps({
            "metric": f"score_chunk_{agg}", "path": "evaluate-ladder",
            "chunk": CHUNK, "smax": args.max_sents,
            "solver": args.solver if agg == "ot" else "n/a",
            "ms_per_chunk": ms(dt),
            "ms_per_query_at_pool": ms(dt, n_chunks),
            "pairs_per_sec": rate(CHUNK, dt),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
