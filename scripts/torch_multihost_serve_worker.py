"""One process of a several-machine SERVING job of the port, for execution
testing (counterpart of scripts/multihost_serve_worker.py).

The dense multi-vector index shards over the serving mesh's "shard" axis:
every process loads the full host index, keeps its own slice of every
bucket (`DenseBucketIndex.device_arrays(mesh=)`), and the per-shard top-k
all_gather and the pool protocol's score all_reduce cross the process
boundary.

Drives both production paths on a deterministic synthetic corpus:
  * global retrieval: index.dense.make_dense_search_batched (sharded scan,
    per-shard top-k, all_gather merge);
  * pool protocol:    index.serve.make_pool_rank_batched (each rank's pool
    members gathered on its device, OT scoring, SUM all_reduce).
Results are dumped per process; tests/test_torch_multihost.py checks that
the processes agree bit for bit and match the one-process run.

Usage (one invocation per process, same --out for all):
  python scripts/torch_multihost_serve_worker.py --coordinator \\
      127.0.0.1:PORT --num-processes 2 --process-id 0 --out /tmp/serve \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

DIM = 16
MS = 6
N_DOCS = 64


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda",
                    help="'cpu' runs gloo ranks on the CPU")
    args = ap.parse_args()

    import numpy as np
    import torch

    from aspire_tpu_torch.index.dense import (build_dense_index,
                                              flatten_device_buckets,
                                              make_dense_search_batched)
    from aspire_tpu_torch.index.serve import make_pool_rank_batched
    from aspire_tpu_torch.parallel.mesh import (initialize_multihost,
                                                make_serving_mesh)

    mesh, device = None, torch.device(args.device)
    if args.num_processes > 1:
        device = initialize_multihost(args.coordinator, args.num_processes,
                                      args.process_id, device=args.device)
        mesh = make_serving_mesh()

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    # deterministic corpus + queries: identical on every process
    rng = np.random.default_rng(3)
    reps = [rng.normal(size=(int(rng.integers(1, MS)), DIM)).astype(np.float32)
            for _ in range(N_DOCS)]
    idx = build_dense_index(reps, [f"p{i}" for i in range(N_DOCS)],
                            n_shards=8, dtype="float32")
    B, qmax, pool = 4, MS, 16
    q = rng.normal(size=(B, qmax, DIM)).astype(np.float32)
    q_lens = rng.integers(1, qmax + 1, B).astype(np.int32)
    for i in range(B):
        q[i, q_lens[i]:] = 0
    cand_ids = np.stack([rng.choice(N_DOCS, pool, replace=False)
                         for _ in range(B)]).astype(np.int32)

    flat = flatten_device_buckets(idx.device_arrays(device, mesh))
    pos = idx.device_pos_arrays(device, mesh)
    put = lambda x: torch.from_numpy(x).to(device)
    search = make_dense_search_batched(len(idx.buckets), k=10, mesh=mesh)
    scores, docs = search(put(q), put(q_lens), *flat)
    pool_fn = make_pool_rank_batched(len(idx.buckets), pool_size=pool,
                                     max_sents=MS, agg="ot", temp=5.0,
                                     mesh=mesh)
    pool_sims = pool_fn(put(q), put(q_lens), put(cand_ids), *flat, *pos)

    np.savez(out / f"serve-proc{args.process_id}.npz",
             scores=scores.cpu().numpy(), docs=docs.cpu().numpy(),
             pool_sims=pool_sims.cpu().numpy())
    (out / f"serve-summary-proc{args.process_id}.json").write_text(
        json.dumps({"process_count": args.num_processes,
                    "world_size": 1 if mesh is None else mesh.world_size}))
    print(f"[proc {args.process_id}] serving done", flush=True)
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
