#!/usr/bin/env python3
"""Times a kernel of two checkouts of this repo in turns on one card.

    python3 benchmarks/torch_kernel_ab.py --other PATH         # attention forward, p = 0
    python3 benchmarks/torch_kernel_ab.py --other PATH --dropout   # forward, p = 0.1 (K5a)
    python3 benchmarks/torch_kernel_ab.py --other PATH --bwd   # backward (K5b)
    python3 benchmarks/torch_kernel_ab.py --other PATH --ffn   # FFN forward (K3)
    python3 benchmarks/torch_kernel_ab.py --other PATH --sinkhorn   # Sinkhorn (K1)

PATH is another checkout (for instance the parent commit unpacked with `git
archive` into a directory that .gitignore lists).  Each checkout builds its own
kernels and is measured in its own process, in the order other, this, this,
other; every reading is the median of 30 CUDA-event readings of 10 calls with
the device given a head start, so the host's share of a call is not in it.
The forward reading is `fused_attention` at dropout_p = 0 (K2); the dropout
reading (`--dropout`) is `fused_attention` at dropout_p = 0.1 with the Philox
mask, called on inputs that require a gradient so that the forward leaves its
row statistics as in a training step (K5a); both with the device milliseconds a
call by kernel under torch.profiler beside them.  The backward
reading (`--bwd`) is `torch.autograd.grad` of `fused_attention` at dropout_p =
0.1 (Philox mask) and at 0, which launches the backward kernels alone, with
the device milliseconds a call by kernel under torch.profiler beside it.  The
FFN reading (`--ffn`) is the no-grad FFN at 4096 and 16384 rows of 768 -> 3072
-> 768 in bf16 and at 4096 rows in f32, through the entry the checkout's model
calls (`fused_ffn_linear` on [out, in] weights where the checkout has it, else
`fused_ffn` on [in, out] ones), with its device milliseconds by kernel.  The
Sinkhorn reading (`--sinkhorn`) is K1 on the serving request's 20 x 20 pairs at
B = 16 and 1024 (f32).  Attention is bf16.  One JSON object a line, then the
card's name and power limit.
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
DROPOUT_SHAPES = ((30, 12, 512, 64), (16, 12, 256, 64))
FFN_CASES = ((4096, "bfloat16"), (16384, "bfloat16"), (4096, "float32"))
SINKHORN_BATCHES = (16, 1024)
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


def measure_ffn() -> None:
    import numpy as np
    import torch
    from aspire_tpu_torch.ops import ffn_kernel as fk
    dev = torch.device("cuda", 0)
    for rows, dtype in FFN_CASES:
        rng = np.random.default_rng(rows)
        arr = lambda *shape, scale=1.0: torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(
            dev, getattr(torch, dtype))
        x, w1, b1 = arr(rows, 768), arr(768, 3072, scale=0.02), arr(3072, scale=0.02)
        w2, b2 = arr(3072, 768, scale=0.02), arr(768, scale=0.02)
        if hasattr(fk, "fused_ffn_linear"):
            w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
            fn = lambda: fk.fused_ffn_linear(x, w1t, b1, w2t, b2)
        else:
            fn = lambda: fk.fused_ffn(x, w1, b1, w2, b2)
        with torch.inference_mode():
            ms = _median_ms(fn)
            by_kernel = _by_kernel(fn)
        print(json.dumps({"rows": rows, "ffn": "768->3072->768", "dtype": dtype,
                          "kernel": "ffn", **ms, "device_ms_by_kernel": by_kernel}),
              flush=True)


def measure_sinkhorn() -> None:
    import torch
    import chip_smoke                   # the checkout's own, on sys.path
    from aspire_tpu_torch.ops.sinkhorn_kernel import sinkhorn_solve
    dev = torch.device("cuda", 0)
    for bsz in SINKHORN_BATCHES:
        *_, cost, la, lb, diam, _, _ = chip_smoke.sinkhorn_inputs(bsz, 7 + bsz, "global", dev)
        fn = lambda: sinkhorn_solve(cost, la, lb, diam)
        print(json.dumps({"batch": bsz, "pairs": "20x20", "dtype": "float32",
                          "kernel": "sinkhorn", **_median_ms(fn),
                          "device_ms_by_kernel": _by_kernel(fn)}), flush=True)


def measure(bwd: bool, dropout: bool) -> None:
    import torch
    from aspire_tpu_torch.ops.attention_kernel import fused_attention
    dev = torch.device("cuda", 0)
    if dropout:
        for b, nh, t, hd in DROPOUT_SHAPES:
            q, k, v, _ = _inputs(b, nh, t, hd, dev)
            bias = torch.zeros((b, t), device=dev)
            leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
            fn = lambda: fused_attention(*leaves, bias, 1.0 / math.sqrt(hd), 0.1,
                                         seed=7, site=1)
            print(json.dumps({"shape": [b, nh, t, hd], "dtype": "bfloat16",
                              "kernel": "forward", "dropout_p": 0.1, **_median_ms(fn),
                              "device_ms_by_kernel": _by_kernel(fn)}), flush=True)
        return
    if not bwd:
        for b, nh, t, hd in SHAPES:
            q, k, v, _ = _inputs(b, nh, t, hd, dev)
            bias = torch.zeros((b, t), device=dev)
            fn = lambda: fused_attention(q, k, v, bias, 1.0 / math.sqrt(hd))
            with torch.inference_mode():
                ms = _median_ms(fn)
                by_kernel = _by_kernel(fn)
            print(json.dumps({"shape": [b, nh, t, hd], "dtype": "bfloat16", **ms,
                              "device_ms_by_kernel": by_kernel}), flush=True)
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
            # a template's first argument tells apart the launches of one kernel
            found = re.search(r"(\w+_kernel)(<\d+)?", e.name)
            name = "".join(filter(None, found.groups())) if found else e.name[:40]
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / calls
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", help="another checkout of the repo")
    parser.add_argument("--bwd", action="store_true",
                        help="time the backward (K5b) instead of the forward")
    parser.add_argument("--dropout", action="store_true",
                        help="time the forward with dropout (K5a) instead")
    parser.add_argument("--ffn", action="store_true",
                        help="time the FFN forward (K3) instead")
    parser.add_argument("--sinkhorn", action="store_true",
                        help="time the Sinkhorn solver (K1) instead")
    parser.add_argument("--measure", action="store_true",
                        help="measure the checkout on sys.path (internal)")
    args = parser.parse_args()
    if args.measure:
        if args.ffn:
            measure_ffn()
        elif args.sinkhorn:
            measure_sinkhorn()
        else:
            measure(args.bwd, args.dropout)
        return 0
    this = pathlib.Path(__file__).resolve().parent.parent
    other = pathlib.Path(args.other).resolve()
    argv = ["ab", "--measure"] + [f"--{flag}" for flag in ("bwd", "dropout", "ffn", "sinkhorn")
                                  if getattr(args, flag)]
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
