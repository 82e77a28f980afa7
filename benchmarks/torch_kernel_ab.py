#!/usr/bin/env python3
"""Times the deterministic attention forward kernel of two checkouts of this
repo in turns on one card.

    python3 benchmarks/torch_kernel_ab.py --other PATH      # needs one GPU

PATH is another checkout (for instance the parent commit unpacked with `git
archive` into a directory that .gitignore lists).  Each checkout builds its own
kernels and is measured in its own process, in the order other, this, this,
other; every reading is the median of 30 CUDA-event readings of 10 launches of
`fused_attention` at dropout_p = 0 with the device given a head start, so the
host's share of a launch is not in it.  One JSON object a line, then the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import subprocess
import sys

SHAPES = ((16, 12, 256, 64), (4, 12, 512, 64), (30, 12, 512, 64))


def measure() -> None:
    import numpy as np
    import torch
    from aspire_tpu_torch.ops.attention_kernel import fused_attention
    dev = torch.device("cuda", 0)
    for b, nh, t, hd in SHAPES:
        rng = np.random.default_rng(t)
        q, k, v = (torch.from_numpy(rng.standard_normal((b, t, nh, hd)).astype(
            np.float32)).to(dev, torch.bfloat16).permute(0, 2, 1, 3) for _ in range(3))
        bias = torch.zeros((b, t), device=dev)
        fn = lambda: fused_attention(q, k, v, bias, 1.0 / math.sqrt(hd))
        with torch.inference_mode():
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            times = []
            for _ in range(30):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(3_000_000)
                start.record()
                for _ in range(10):
                    fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 10)
        print(json.dumps({"shape": [b, nh, t, hd], "dtype": "bfloat16",
                          "ms_median": statistics.median(times),
                          "ms_min": min(times), "ms_max": max(times)}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", help="another checkout of the repo")
    parser.add_argument("--measure", action="store_true",
                        help="measure the checkout on sys.path (internal)")
    args = parser.parse_args()
    if args.measure:
        measure()
        return 0
    this = pathlib.Path(__file__).resolve().parent.parent
    other = pathlib.Path(args.other).resolve()
    for label, root in (("other", other), ("this", this), ("this", this),
                        ("other", other)):
        code = (f"import sys; sys.path.insert(0, {str(root)!r}); "
                f"sys.argv = ['ab', '--measure']; "
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
