#!/usr/bin/env python3
"""Device-time breakdown of one serving request of aspire_tpu_torch.

    python3 benchmarks/torch_serve_profile.py [--plain]     # needs one GPU

Builds the same full-width bf16 ConSent encoder and the same 16 x 256-token
requests as `chip_smoke.py`, answers a few warm-up requests, then answers
`--requests` more under `torch.profiler` and prints, one JSON object a line:
the span from the first device kernel's start to the last one's end, the
device's busy time and idle share in that span, the device time by class
(each of the path's kernels, K1-K4, the cuBLAS products, the rest) and the
device kernels by total time.  `--plain` profiles the plain path (naive
attention and FFN, PyTorch solver) instead of the kernel path.  Last, the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the request and weight generators)


CLASSES = (
    ("sinkhorn (K1)", ("sinkhorn_",)),
    ("attention (K2)", ("attention_bf16_kernel", "attention_tf32x3_kernel")),
    ("ffn (K3)", ("ffn_bf16_kernel", "ffn_tf32x3_kernel", "split_tf32_kernel")),
    ("pool (K4)", ("pool_kernel",)),
    ("cuBLAS products", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
)


def classify(name: str) -> str:
    for label, needles in CLASSES:
        if any(n in name for n in needles):
            return label
    return "other device kernels"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--plain", action="store_true")
    parser.add_argument("--requests", type=int, default=3)
    parser.add_argument("--top", type=int, default=14)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from aspire_tpu_torch.models.bert import BertConfig
    from aspire_tpu_torch.models.convert import state_dict_from_flax_params
    from aspire_tpu_torch.models.encoders import ConSentEncoder

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = BertConfig()
    impl = "naive" if args.plain else "auto"
    enc = ConSentEncoder(cfg, max_sents=20, dtype=torch.bfloat16, device=dev,
                         attention_impl=impl, ffn_impl=impl).eval()
    enc.load_state_dict(state_dict_from_flax_params(
        chip_smoke.random_flax_tree(cfg, seed=0), cfg))
    solver = "torch" if args.plain else "kernel"
    requests = [chip_smoke.make_request(cfg, 100 + i, dev)
                for i in range(args.requests)]
    with torch.inference_mode():
        for request in requests:                     # warm-up, kernel build
            chip_smoke.answer(enc, request, solver)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for request in requests:
                chip_smoke.answer(enc, request, solver)
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
        "path": "plain" if args.plain else "kernel", "requests": args.requests,
        "device_span_ms": span_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / span_ms,
        "host_wall_ms_with_profiler": wall_ms}))
    by_class: dict = {}
    for name, (ms, count) in by_name.items():
        ms0, count0 = by_class.get(classify(name), (0.0, 0))
        by_class[classify(name)] = (ms0 + ms, count0 + count)
    for label, (ms, count) in sorted(by_class.items(), key=lambda kv: -kv[1][0]):
        print(json.dumps({"class": label, "device_ms_a_request": ms / args.requests,
                          "share_of_busy": ms / busy_ms,
                          "launches_a_request": count / args.requests}))
    rows = sorted(((ms, count, name) for name, (ms, count) in by_name.items()),
                  reverse=True)
    for ms, count, name in rows[:args.top]:
        print(json.dumps({"device_ms": ms, "share_of_busy": ms / busy_ms,
                          "calls": count, "class": classify(name),
                          "kernel": name[:90]}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
