#!/usr/bin/env python3
"""Times the large-pair Sinkhorn kernel (K1 past one block's shared memory,
csrc/sinkhorn.cu `sinkhorn_cluster_kernel`) at every cluster size whose
slice fits, beside the one `cluster_plan` picks.

    python3 benchmarks/torch_sinkhorn_cluster_sweep.py            # needs one GPU and nvcc
    python3 benchmarks/torch_sinkhorn_cluster_sweep.py --check    # errors only, no times
    python3 benchmarks/torch_sinkhorn_cluster_sweep.py --extremes # the route's edges, the plan alone

For each case (B pairs of n x m: the fused queries' reranks and
chip_smoke.py's large cases, made by `chip_smoke.sinkhorn_inputs`) and each
c in 1..8 whose potentials fit (`cluster_fit`: its resident rows), one
line: the layout's team and pitch, the clusters the card holds at once
(`cluster_capacity`), the largest error of f and g against the plain version
on the atoms with mass in both modes (after the final step, and the loop's
own potentials), and, unless --check, the median (min, max) ms of 20
CUDA-event readings of 5 launches after a head start of the device.  The
plan's row carries `"plan": true`.  One JSON object a line, then the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CASES = ((16, 300, 1200), (20, 300, 1200), (160, 300, 1200), (16, 24, 1200),
         (16, 240, 240), (16, 512, 512), (30, 300, 300), (16, 1200, 1200))
# the edges of the large route: n + m = 29,056 both ways and square, a side
# of 1,025 against one atom
EXTREMES = ((1, 14528, 14528), (1, 29032, 24), (1, 24, 29032), (2, 1, 1025))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--check", action="store_true", help="errors only, no times")
    parser.add_argument("--batch", type=int, help="every case at this batch instead")
    parser.add_argument("--extremes", action="store_true",
                        help="the plan's layout alone at the route's edges, errors and ms "
                             "of one call")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from aspire_tpu_torch.ops import _build
    from aspire_tpu_torch.ops import sinkhorn_kernel as sk
    dev = torch.device("cuda", 0)
    _build.load()
    # registers and spill bytes of the cluster kernel from nvcc's log
    found = re.search(r"Compiling entry function '(\w*sinkhorn_cluster\w*)'.*?(\d+) bytes "
                      r"spill stores, (\d+) bytes spill loads.*?Used (\d+) registers",
                      _build.build_log, re.S)
    print(json.dumps({"build_seconds": _build.build_seconds,
                      "registers_spill_stores_loads": found and [int(found.group(4)),
                                                                int(found.group(2)),
                                                                int(found.group(3))]}),
          flush=True)
    plan = sk.cluster_plan
    for bsz, n, m in EXTREMES if args.extremes else CASES:
        bsz = args.batch or bsz
        q, c_, cost, la, lb, diam, a, b = chip_smoke.sinkhorn_inputs(bsz, 7 + bsz + n + m,
                                                                     "pair", dev, n, m)
        del q, c_
        want = {e: sk.sinkhorn_solve_plain(cost, la, lb, diam, extrapolate=e)
                for e in (True, False)}
        chosen = plan(bsz, n, m)
        layouts = [(c, sk.cluster_fit(n, m, c)) for c in range(1, sk.CLUSTER_MAX + 1)
                   if sk.cluster_fit(n, m, c) is not None]
        if args.extremes:
            layouts = [chosen]
        for layout in layouts:
            lay = sk.cluster_layout(n, m, *layout)
            sk.cluster_plan = lambda *_, layout=layout: layout
            try:
                row = {"batch": bsz, "pairs": f"{n}x{m}", "c": layout[0],
                       "res_rows": layout[1], "plan": layout == chosen,
                       "team": lay.team, "pitch": lay.pitch, "smem_bytes": 4 * lay.floats,
                       "clusters_at_once": sk.cluster_capacity(n, m, *layout)}
                for e, (fp, gp) in want.items():
                    f, g = sk.sinkhorn_solve(cost, la, lb, diam, extrapolate=e)
                    torch.cuda.synchronize()
                    err = max(float((f - fp).abs()[a > 0].max()),
                              float((g - gp).abs()[b > 0].max()))
                    row["max_abs_err" if e else "loop_only_max_abs_err"] = err
                if args.extremes:
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    sk.sinkhorn_solve(cost, la, lb, diam)
                    end.record()
                    end.synchronize()
                    row["ms"] = start.elapsed_time(end)
                elif not args.check:
                    t = chip_smoke.cuda_ms(lambda: sk.sinkhorn_solve(cost, la, lb, diam))
                    row.update(ms=t["median"], ms_min=t["min"], ms_max=t["max"])
            finally:
                sk.cluster_plan = plan
            print(json.dumps(row), flush=True)
        del cost, want
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
