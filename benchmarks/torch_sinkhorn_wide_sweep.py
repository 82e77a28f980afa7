#!/usr/bin/env python3
"""K1's wide-pair kernel at every team of O lanes its launch can take, beside
the large-pair (cluster) kernel on the same inputs, on one card.

    python3 benchmarks/torch_sinkhorn_wide_sweep.py            # every case, every team
    python3 benchmarks/torch_sinkhorn_wide_sweep.py --witness  # and chip_smoke.case_sinkhorn at the plan

The cases are chip_smoke.py's wide K1 cases (`CASES`: an abstract's query
against 20 and 160 full-text candidates of 800 sentences, 48 x 40 at B = 16
and 1,024, 100 x 100, the route's edges 239 x 239 and 55 x 1,024, then pairs
whose table of rounds is short or empty, turned, or of one atom), inputs from
`chip_smoke.sinkhorn_inputs` (768-d sentence reps, temp 5000, per-pair
diameters).  For each case and each team in `TEAMS` that the kernel takes
(`wide_threads`: its L threads whole warps, at most WIDE_PER L atoms each;
`wide_layout` within one block's shared memory), `aspire_sinkhorn_wide_f32`
is launched directly with that team: its largest error against
`sinkhorn_solve_plain` on the atoms with mass in both modes (after the final
step, and the loop's own potentials), and its milliseconds by CUDA events
(median of 20 readings of 5 launches, as chip_smoke.cuda_ms); `plan` marks
the team `wide_plan` takes.  Then the large-pair kernel at `cluster_plan`'s
blocks a pair and resident rows on the same inputs.  One JSON object a line;
first the build's registers and spills of the Sinkhorn kernels, last the
card's name and power limit.  Errors above 1e-3 are printed, not raised.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import re
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

CASES = ((20, 20, 800), (160, 20, 800), (16, 48, 40), (1024, 48, 40), (16, 100, 100),
         (16, 239, 239), (16, 55, 1024), (4, 226, 255), (4, 1024, 55), (4, 1, 1024),
         (4, 33, 1))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--witness", action="store_true",
                        help="also chip_smoke.case_sinkhorn (f64 witness) at each plan")
    args = parser.parse_args()
    import torch
    import chip_smoke
    from aspire_tpu_torch.ops import _build
    from aspire_tpu_torch.ops import sinkhorn_kernel as sk

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    lib = _build.load()
    ptxas = {m.group(1): [int(m.group(4)), int(m.group(2)), int(m.group(3))]
             for m in re.finditer(r"Compiling entry function '(\w*sinkhorn\w*)'.*?"
                                  r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
                                  r"Used (\d+) registers", _build.build_log, re.S)}
    print(json.dumps({"ptxas_registers_spill_stores_loads": ptxas}), flush=True)
    for bsz, n, m in CASES:
        _, _, cost, la, lb, diam, a, b = chip_smoke.sinkhorn_inputs(
            bsz, 7 + bsz + n + m, "pair", dev, n, m)
        plain = {e: sk.sinkhorn_solve_plain(cost, la, lb, diam, extrapolate=e)
                 for e in (True, False)}
        plan = sk.wide_plan(n, m)
        f = torch.empty((bsz, n), device=dev)
        g = torch.empty((bsz, m), device=dev)

        def launch(team, threads, extrapolate=True):
            err = lib.aspire_sinkhorn_wide_f32(
                cost.data_ptr(), la.data_ptr(), lb.data_ptr(), diam.data_ptr(),
                f.data_ptr(), g.data_ptr(), bsz, n, m, team, threads, 0.05,
                math.log(0.9), 128, int(extrapolate),
                torch.cuda.current_stream().cuda_stream)
            _build.check(err, "aspire_sinkhorn_wide_f32")

        for team in sk.TEAMS:
            o_thr, nl = sk.wide_threads(n, m, team)
            lay = sk.wide_layout(n, m, team)
            if nl < 32 or -(-max(n, m) // nl) > sk.WIDE_PER \
                    or 4 * lay.floats > sk.MAX_SMEM:
                continue
            errs = {}
            for e in (True, False):
                launch(team, o_thr + nl, e)
                torch.cuda.synchronize()
                fp, gp = plain[e]
                errs["extrapolated" if e else "loop_only"] = max(
                    float((f - fp).abs()[a > 0].max()), float((g - gp).abs()[b > 0].max()))
            row = {"case": f"B={bsz} {n}x{m}", "team": team, "threads": o_thr + nl,
                   "o_threads": o_thr, "pitch": lay.pitch, "table": lay.table,
                   "plan": (team, o_thr + nl) == plan, "max_abs_err": errs,
                   "within_1e-3": max(errs.values()) <= 1e-3,
                   "ms": chip_smoke.cuda_ms(lambda: launch(team, o_thr + nl))}
            print(json.dumps(row), flush=True)
        c, res = sk.cluster_plan(bsz, n, m)
        fc, gc = torch.empty_like(f), torch.empty_like(g)

        def cluster():
            err = lib.aspire_sinkhorn_large_f32(
                cost.data_ptr(), la.data_ptr(), lb.data_ptr(), diam.data_ptr(),
                fc.data_ptr(), gc.data_ptr(), bsz, n, m, c, res, 0.05, math.log(0.9), 128, 1,
                torch.cuda.current_stream().cuda_stream)
            _build.check(err, "aspire_sinkhorn_large_f32")

        cluster()
        torch.cuda.synchronize()
        fp, gp = plain[True]
        err = max(float((fc - fp).abs()[a > 0].max()), float((gc - gp).abs()[b > 0].max()))
        print(json.dumps({"case": f"B={bsz} {n}x{m}", "kernel": "cluster", "blocks_a_pair": c,
                          "resident_rows": res, "max_abs_err": err,
                          "ms": chip_smoke.cuda_ms(cluster)}), flush=True)
        del cost, la, lb, diam, plain
        torch.cuda.empty_cache()
        if args.witness:
            row = chip_smoke.case_sinkhorn(bsz, "pair", dev, n, m)
            print(json.dumps({"case_sinkhorn": row}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
