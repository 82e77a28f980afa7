#!/usr/bin/env python3
"""Device-time breakdown of the evaluation path of aspire_tpu_torch.

    python3 benchmarks/torch_eval_profile.py [--plain]     # needs one GPU

Writes the same BERT-base HF directory (random weights, seed 21) and
CSFCube-layout dataset as `chip_smoke.py`'s eval phase (fewer abstracts),
loads it with `AspireSimilarityModel.from_hf_dir` (f32, as `evaluate` runs
it), warms up, then profiles under `torch.profiler` two stages apart:

  encode  `--batches` batches of 8 abstracts (`model.encode`: K2, K3, K4 and
          the cuBLAS projections at 8 x 512 tokens);
  score   `--queries` queries, each against its pool of 120 encoded
          candidates (`model.get_similarities`: one chunk of 256 pairs, K1
          with `--ot-solver pallas`; the plain loop with `--plain`).

For each stage it prints, one JSON object a line: host wall ms, the device
span, busy time and idle share, the device time by class, the host ms spent
packing the query and its candidates (`_pack`) for the score stage, and the
top device kernels.
`--plain` runs the plain route (naive attention, FFN and pool; the plain
Sinkhorn loop).  Last, the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the checkpoint and dataset generators)
from torch_serve_profile import classify  # noqa: E402


def device_breakdown(prof, label: str, units: int, wall_ms: float,
                     top: int, extra: dict) -> None:
    by_name: dict = {}
    first, last = None, 0.0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        first = start if first is None else min(first, start)
        last = max(last, end)
        ms, count = by_name.get(evt.name, (0.0, 0))
        by_name[evt.name] = (ms + (end - start) / 1e3, count + 1)
    if not by_name:
        raise RuntimeError("the profiler recorded no device activity")
    busy_ms = sum(ms for ms, _ in by_name.values())
    span_ms = (last - first) / 1e3
    print(json.dumps({"stage": label, "units": units,
                      "host_wall_ms_with_profiler": wall_ms,
                      "host_ms_a_unit": wall_ms / units,
                      "device_span_ms": span_ms, "device_busy_ms": busy_ms,
                      "device_busy_ms_a_unit": busy_ms / units,
                      "device_idle_share": 1.0 - busy_ms / span_ms, **extra}))
    by_class: dict = {}
    for name, (ms, count) in by_name.items():
        ms0, count0 = by_class.get(classify(name), (0.0, 0))
        by_class[classify(name)] = (ms0 + ms, count0 + count)
    for cls, (ms, count) in sorted(by_class.items(), key=lambda kv: -kv[1][0]):
        print(json.dumps({"stage": label, "class": cls,
                          "device_ms_a_unit": ms / units,
                          "share_of_busy": ms / busy_ms,
                          "launches_a_unit": count / units}))
    rows = sorted(((ms, count, name) for name, (ms, count) in by_name.items()),
                  reverse=True)
    for ms, count, name in rows[:top]:
        print(json.dumps({"stage": label, "device_ms": ms,
                          "share_of_busy": ms / busy_ms, "calls": count,
                          "class": classify(name), "kernel": name[:90]}))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--plain", action="store_true")
    parser.add_argument("--batches", type=int, default=5)
    parser.add_argument("--queries", type=int, default=5)
    parser.add_argument("--docs", type=int, default=600)
    parser.add_argument("--top", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from aspire_tpu_torch.evaluation.datasets import EvalDataset
    from aspire_tpu_torch.evaluation.models import AspireSimilarityModel
    from aspire_tpu_torch.models.bert import BertConfig

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = BertConfig(vocab_size=30522)
    vocab = chip_smoke.eval_vocab(cfg.vocab_size)
    impl = "naive" if args.plain else "auto"
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.write_hf_dir(f"{tmp}/hf", cfg, vocab, seed=21)
        chip_smoke.write_csfcube(f"{tmp}/data", vocab, seed=22, n_docs=args.docs)
        model = AspireSimilarityModel.from_hf_dir(
            "m", f"{tmp}/hf", device=dev, attention_impl=impl, ffn_impl=impl,
            pool_impl=impl, ot_solver="xla" if args.plain else "pallas")
        ds = EvalDataset("csfcube", f"{tmp}/data")
        pool = ds.get_test_pool("method")
        papers = [ds.get(pid) for pid, _ in list(ds)[:8 * (args.batches + 1)]]
        qpids = list(pool)[:args.queries + 1]
        encs = {q: model.get_encoding([q] + pool[q]["cands"], ds) for q in qpids}

    def encode(batches):
        for i in batches:
            model.encode(papers[8 * i:8 * i + 8])

    def score(queries):
        for q in queries:
            qe = model.get_faceted_encoding(encs[q][q], "method", ds.get(q))
            model.get_similarities(qe, [encs[q][c] for c in pool[q]["cands"]])

    pack = model._pack
    pack_s = [0.0]

    def timed_pack(*a):
        t0 = time.perf_counter()
        out = pack(*a)
        pack_s[0] += time.perf_counter() - t0
        return out

    encode([0])
    score(qpids[:1])                                   # warm-up, kernel build
    for label, fn, units, work in (
            ("encode", encode, args.batches, range(1, args.batches + 1)),
            ("score", score, args.queries, qpids[1:])):
        model._pack = timed_pack
        pack_s[0] = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(work)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        model._pack = pack
        extra = {"path": "plain" if args.plain else "kernel"}
        if label == "score":
            extra["host_ms_packing_a_unit"] = pack_s[0] * 1e3 / units
        device_breakdown(prof, label, units, wall_ms, args.top, extra)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
