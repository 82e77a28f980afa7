#!/usr/bin/env python3
"""Times an attention kernel of two checkouts of this repo in turns on one card.

    python3 benchmarks/torch_kernel_ab.py --other PATH         # forward, p = 0
    python3 benchmarks/torch_kernel_ab.py --other PATH --bwd   # backward (K5b)

PATH is another checkout (for instance the parent commit unpacked with `git
archive` into a directory that .gitignore lists).  Each checkout builds its own
kernels and is measured in its own process, in the order other, this, this,
other; every reading is the median of 30 CUDA-event readings of 10 calls with
the device given a head start, so the host's share of a call is not in it.
The forward reading is `fused_attention` at dropout_p = 0 (K2); the backward
reading (`--bwd`) is `torch.autograd.grad` of `fused_attention` at dropout_p =
0.1 (Philox mask) and at 0, which launches the backward kernels alone, with
the device milliseconds a call by kernel under torch.profiler beside it.  All
bf16.  One JSON object a line, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys

SHAPES = ((16, 12, 256, 64), (4, 12, 512, 64), (30, 12, 512, 64))
BWD_CASES = (((30, 12, 512, 64), 0.1), ((30, 12, 512, 64), 0.0),
             ((16, 12, 256, 64), 0.1), ((16, 12, 256, 64), 0.0))


def _median_ms(fn, calls: int = 10, readings: int = 30) -> dict:
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(readings):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(3_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return {"ms_median": statistics.median(times), "ms_min": min(times),
            "ms_max": max(times)}


def _inputs(b, nh, t, hd, dev):
    import numpy as np
    import torch
    rng = np.random.default_rng(t)
    return [torch.from_numpy(rng.standard_normal((b, t, nh, hd)).astype(
        np.float32)).to(dev, torch.bfloat16).permute(0, 2, 1, 3) for _ in range(4)]


def measure(bwd: bool) -> None:
    import torch
    from aspire_tpu_torch.ops.attention_kernel import fused_attention
    dev = torch.device("cuda", 0)
    if not bwd:
        for b, nh, t, hd in SHAPES:
            q, k, v, _ = _inputs(b, nh, t, hd, dev)
            bias = torch.zeros((b, t), device=dev)
            with torch.inference_mode():
                ms = _median_ms(lambda: fused_attention(q, k, v, bias, 1.0 / math.sqrt(hd)))
            print(json.dumps({"shape": [b, nh, t, hd], "dtype": "bfloat16", **ms}),
                  flush=True)
        return
    for (b, nh, t, hd), p in BWD_CASES:
        q, k, v, g = _inputs(b, nh, t, hd, dev)
        bias = torch.zeros((b, t), device=dev)
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        out = fused_attention(*leaves, bias, 1.0 / math.sqrt(hd), p, seed=7, site=1)
        fn = lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)
        ms = _median_ms(fn)
        print(json.dumps({"shape": [b, nh, t, hd], "dtype": "bfloat16",
                          "kernel": "backward", "dropout_p": p, **ms,
                          "device_ms_by_kernel": _by_kernel(fn)}), flush=True)


def _by_kernel(fn, calls: int = 10) -> dict:
    """Device milliseconds a call by kernel name, under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "#" not in e.name:
            found = re.findall(r"(\w+_kernel)\b", e.name)
            name = found[0] if found else e.name[:40]
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / calls
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", help="another checkout of the repo")
    parser.add_argument("--bwd", action="store_true",
                        help="time the backward (K5b) instead of the forward")
    parser.add_argument("--measure", action="store_true",
                        help="measure the checkout on sys.path (internal)")
    args = parser.parse_args()
    if args.measure:
        measure(args.bwd)
        return 0
    this = pathlib.Path(__file__).resolve().parent.parent
    other = pathlib.Path(args.other).resolve()
    argv = ["ab", "--measure"] + (["--bwd"] if args.bwd else [])
    for label, root in (("other", other), ("this", this), ("this", this),
                        ("other", other)):
        code = (f"import sys; sys.path.insert(0, {str(root)!r}); "
                f"sys.argv = {argv!r}; "
                f"exec(open({str(pathlib.Path(__file__).resolve())!r}).read())")
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, cwd=root)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        for line in out.stdout.splitlines():
            print(json.dumps({"checkout": label, **json.loads(line)}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
