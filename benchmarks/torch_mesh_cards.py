"""The mesh phase's two paths with one rank a card over NCCL, against one
process on one card, in one call: on a machine of four H100s.

    python3 benchmarks/torch_mesh_cards.py            # 4 serving ranks, 3 data ranks
    python3 benchmarks/torch_mesh_cards.py --index-docs 20000 --layers 2

  serve   chip_smoke.py's 125,000-document bf16 and int8 indexes (its
          build_large_index, saved and mapped), 4 shard ranks on cuda:0-3
          (chip_smoke.mesh_serve_rank: a single bf16 fused query at k=50, a
          batch of 32 on int8 at k=64, a pool ranking of 8 x 512 ids, each
          timed on rank 0's host clock, the stages apart); then the same
          queries in this process on cuda:0 against the whole index, timed
          the same way, and the answers compared (chip_smoke.compare_answers).
  train   the flagship (BERT-base width, [10, 3, 512], bf16 over f32
          parameters, Adam) on 3 data ranks, cuda:0-2 (chip_smoke.
          mesh_train_rank: the first step's loss and gradient norms, three
          steps with a dev check after the third); then the same first step
          and three steps in this process on cuda:0.

Prints one JSON line a path and the card's name and power limit.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def serve(cs, dev, index_docs: int, shards: int) -> dict:
    import torch
    from aspire_tpu_torch.index.dense import (DenseBucketIndex,
                                              flatten_device_buckets)
    from aspire_tpu_torch.index.serve import (make_fused_query,
                                              make_fused_query_batched,
                                              make_pool_rank_batched)
    from aspire_tpu_torch.parallel.mesh import run_ranks
    with tempfile.TemporaryDirectory(prefix="mesh_cards_") as tmp:
        cs.build_large_index(None, index_docs, save_dir=tmp)
        ranks = run_ranks(cs.mesh_serve_rank, shards, tmp, index_docs,
                          device="cuda")
        q_np, q_lens_np, cand_np = cs.index_query_inputs(index_docs)
        q, q_lens = (torch.from_numpy(x).to(dev) for x in (q_np, q_lens_np))
        cand = torch.from_numpy(cand_np).to(dev)
        one, answers = {}, {}
        for storage in ("bfloat16", "int8"):
            idx = DenseBucketIndex.load(pathlib.Path(tmp) / storage, mmap=True)
            flat = flatten_device_buckets(idx.device_arrays(dev))
            pos = idx.device_pos_arrays(dev)
            nb = len(idx.buckets)
            kw = dict(max_sents=20, temp=5000.0)
            if storage == "bfloat16":
                calls = {"single bf16": lambda: tuple(
                    x[None] for x in make_fused_query(nb, k=50, **kw)(
                        q[0], q_lens[0], *flat, *pos)),
                    "pool rank": lambda: (make_pool_rank_batched(
                        nb, pool_size=512, agg="ot", **kw)(
                            q[:8], q_lens[:8], cand, *flat, *pos),)}
            else:
                calls = {"batch of 32 int8": lambda: make_fused_query_batched(
                    nb, k=64, int8=True, **kw)(q, q_lens, *flat, *pos)}
            for name, fn in calls.items():
                fn()
                one[name], answers[name] = cs._host_ms(fn)
            del idx, flat, pos
    check = {}
    for name in ("single bf16", "batch of 32 int8"):
        got = tuple(torch.from_numpy(x).reshape(a.shape) for x, a in
                    zip(ranks[0]["answers"][name], answers[name]))
        check[name] = cs.compare_answers(name, got, tuple(
            x.cpu() for x in answers[name]))
    live = torch.from_numpy(cand_np >= 0)
    check["pool rank"] = cs.check_close(
        "pool rank", torch.from_numpy(ranks[0]["answers"]["pool rank"][0])[live],
        answers["pool rank"][0].cpu()[live], atol=1e-2, rtol=5e-3)
    return {"path": "serve", "docs": index_docs, "ranks": shards,
            "backend": ranks[0]["backend"],
            "rank_devices": [r["device"] for r in ranks],
            "sharded_ms": ranks[0]["ms"], "sharded_stages": ranks[0]["stages"],
            "one_card_ms": one, "sharded_against_one_card": check,
            "launches_per_rank": [{k: v for k, v in r["counts"].items() if v}
                                  for r in ranks],
            "peak_memory_mb": [r["peak_memory_mb"] for r in ranks]}


def train(cs, dev, layers: int, ranks_n: int) -> dict:
    import torch
    from aspire_tpu_torch.core.config import RunConfig
    from aspire_tpu_torch.parallel.mesh import run_ranks
    from aspire_tpu_torch.train.trainer import Trainer
    cfg, steps, tp, dev_batch = cs.mesh_train_steps(layers)
    with tempfile.TemporaryDirectory(prefix="mesh_cards_run_") as run_dir:
        ranks = run_ranks(cs.mesh_train_rank, ranks_n, layers, run_dir,
                          device="cuda")
    hp, model = cs.flagship(cfg, dev)
    with tempfile.TemporaryDirectory(prefix="mesh_cards_one_") as run_dir:
        trainer = Trainer(model, RunConfig(model=hp, train=tp), run_dir,
                          fused_accum=True)
        state = trainer.init_state()
        want = cs._first_step_check(model, trainer, state, steps[0],
                                    cs.MESH_TRAIN_SEED, 10, None)
        marks, counts = [], []
        torch.cuda.reset_peak_memory_stats(dev)
        trainer.train(state, cs._timed(steps, marks, counts),
                      dev_batches_fn=lambda: [dev_batch],
                      seed=cs.MESH_TRAIN_SEED)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    tol = cs.STEP_TOL[torch.bfloat16]
    worst = max(max(abs(r["first_step"][1][g] - want[1][g]) / want[1][g]
                    for g in want[1]) for r in ranks)
    rel = max(abs(r["first_step"][0] - want[0]) / abs(want[0]) for r in ranks)
    if rel > tol["loss_rel"] or worst > tol["grad_norm_rel"] \
            or len({r["digest"] for r in ranks}) != 1:
        raise AssertionError(f"train: loss off by {rel}, norms by {worst}, "
                             f"digests {[r['digest'] for r in ranks]}")
    return {"path": "train", "ranks": ranks_n, "backend": ranks[0]["backend"],
            "rank_devices": [r["device"] for r in ranks], "layers": layers,
            "superbatch": [10, 3, 512], "step_ms": [r["step_ms"] for r in ranks],
            "one_card_step_ms": [(b - a) * 1e3 for a, b in
                                 zip(marks[:-1], marks[1:])],
            "peak_memory_mb": [r["peak_memory_mb"] for r in ranks],
            "one_card_peak_memory_mb": peak, "loss_rel_err": rel,
            "grad_norm_rel_worst": worst, "params_equal": True,
            "gradient_all_reduce_bytes": 4 * ranks[0]["n_params"]}


def main() -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--index-docs", type=int, default=125_000)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--data-ranks", type=int, default=3,
                    help="ranks of the flagship's micro batch of 3")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs CUDA devices", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"cards": smi.splitlines(),
                      "count": torch.cuda.device_count()}), flush=True)
    for fn, a in ((serve, (args.index_docs, args.shards)),
                  (train, (args.layers, args.data_ranks))):
        t0 = time.perf_counter()
        out = fn(cs, dev, *a)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    print(smi.splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
