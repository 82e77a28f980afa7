#!/usr/bin/env python3
"""Device-time breakdown of fused index queries of aspire_tpu_torch.

    python3 benchmarks/torch_index_profile.py [--docs N] [--plain]   # needs one GPU

Builds the same bf16 and int8 dense-bucket indexes as `chip_smoke.py`'s index
phase (125,000 documents by default, on the host, then on the card), answers
warm-up queries, then answers `--calls` more of each kind -- a single query on
bf16 (k=50), a single query on int8 (k=64), a batch of 32 on int8 (k=64) --
first on the host's clock around a synchronise, then under `torch.profiler`,
and prints for each kind, one JSON object a line: milliseconds a call without
the profiler, the span from the first device kernel's start to the last one's
end, the device's busy time and idle share in that span, and the device
kernels by total time.  `--plain` profiles the plain route (scan='torch',
solver='torch').  `--int8-only --fine-buckets --docs 1000000` is the capacity
reading: one million documents in int8 with buckets (8, 12, 16, 20, 24).
Last, the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the index and query generators)

KINDS = (("single bf16", "bfloat16", 1, 50), ("single int8", "int8", 1, 64),
         ("batch of 32 int8", "int8", 32, 64))


def profiled(label: str, fn, calls: int, top: int) -> None:
    for _ in range(2):                                   # warm-up, kernel build
        fn()
    host_ms = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only (an operator's row repeats its kernels' time)
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
    print(json.dumps({
        "query": label, "calls": calls,
        "host_ms_a_call": statistics.median(host_ms),
        "host_ms_a_call_spread": [min(host_ms), max(host_ms)],
        "device_span_ms": span_ms,
        "device_busy_ms": busy_ms, "device_busy_ms_a_call": busy_ms / calls,
        "device_idle_share": 1.0 - busy_ms / span_ms,
        "host_wall_ms_a_call_with_profiler": wall_ms / calls}), flush=True)
    rows = sorted(((ms, count, name) for name, (ms, count) in by_name.items()),
                  reverse=True)
    for ms, count, name in rows[:top]:
        print(json.dumps({"query": label, "device_ms_a_call": ms / calls,
                          "share_of_busy": ms / busy_ms,
                          "launches_a_call": count / calls,
                          "kernel": name[:90]}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--docs", type=int, default=125_000)
    parser.add_argument("--plain", action="store_true")
    parser.add_argument("--calls", type=int, default=5)
    parser.add_argument("--top", type=int, default=10)
    parser.add_argument("--int8-only", action="store_true",
                        help="skip the bf16 index and its query")
    parser.add_argument("--fine-buckets", action="store_true",
                        help="buckets (8, 12, 16, 20, 24) instead of (12, 24)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    from aspire_tpu_torch.index.dense import flatten_device_buckets
    from aspire_tpu_torch.index.serve import make_fused_query_batched

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    big = chip_smoke.build_large_index(
        dev, args.docs,
        buckets=(8, 12, 16, 20, 24) if args.fine_buckets else (12, 24),
        storages=("int8",) if args.int8_only else ("bfloat16", "int8"))
    print(json.dumps({"docs": args.docs, "sentences": big["sentences"],
                      "buckets": big["bucket_sizes"],
                      "device_memory_mb": torch.cuda.memory_allocated() / 2 ** 20,
                      "stored_bytes": big["stored"],
                      "host_seconds": big["host_seconds"],
                      "route": "plain" if args.plain else "kernel"}), flush=True)
    rng = np.random.default_rng(1)
    q_lens = rng.integers(3, 17, 32)
    q = rng.standard_normal((32, 16, big["dim"])).astype(np.float32) * 2
    q *= (np.arange(16)[None, :] < q_lens[:, None])[:, :, None]
    q, q_lens = torch.from_numpy(q).to(dev), torch.from_numpy(q_lens).to(dev)
    route = dict(scan="torch", solver="torch") if args.plain else {}
    for label, storage, bsz, k in KINDS:
        if storage not in big["buckets"]:
            continue
        flat = flatten_device_buckets(big["buckets"][storage])
        fn = make_fused_query_batched(
            len(big["buckets"][storage]), k=k, max_sents=20, int8=storage == "int8",
            temp=5000.0, q_chunk=8 if args.plain and bsz > 8 else None, **route)
        profiled(label, lambda: fn(q[:bsz], q_lens[:bsz], *flat,
                                   *big["pos"][storage]), args.calls, args.top)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
