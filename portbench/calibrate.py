#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 \
        --control-seeds 3 [--first-seed N]                       # needs one GPU

For each seed: the cell's set-up, one call of each of its distinct input
batches at the cell's own sizes (the timed path), then the numbers that
decide `correct` for the program (the lower readings), and for the first
--control-seeds seeds the same numbers for the control: the reference in the
precision below the configuration's (an fp8 encoder, an int4 scan, a bf16
Sinkhorn solve) put in the program's place (the upper readings).  One JSON
object a line, then a summary: per number the largest program reading, the
smallest control reading, and the limit the workload file holds.  The
benchmark's own runs never run the control."""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def readings(cell: str, seeds: list, control_seeds: int, device,
             overrides: dict | None = None, out=print) -> dict:
    """{"program": {number: [a reading a seed]}, "control": {...}}."""
    import torch
    from portbench.lib.cell import cell_spec, load_module

    spec = cell_spec(cell)
    overrides = overrides or {}
    cfg = {**spec["config_spec"], **overrides.get("config", {})}
    traffic = {**spec["traffic_spec"], **overrides.get("traffic", {})}
    kind = load_module("kinds", traffic["kind"])
    got: dict = {"program": {}, "control": {}}
    for n, seed in enumerate(seeds):
        t0 = time.perf_counter()
        state = kind.setup(cfg, traffic, seed, device)
        for i in range(traffic["distinct_batches"]):
            state.step(i)
        state.free_program()
        sides = [("program", False)] + ([("control", True)] if n < control_seeds else [])
        for side, lower in sides:
            numbers = state.check(lower=lower)
            for k, v in numbers.items():
                got[side].setdefault(k, []).append(v)
            out(json.dumps({"cell": cell, "seed": seed, "side": side, **numbers,
                            "seconds": time.perf_counter() - t0}))
        del state
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=1_000_003)
    args = ap.parse_args(argv)
    import torch
    from portbench.lib.cell import cell_spec
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    got = readings(args.workload, seeds, args.control_seeds, device,
                   out=lambda s: print(s, flush=True))
    limits = cell_spec(args.workload)["limits"]
    for k in got["program"]:
        print(json.dumps({"number": k, "program_max": max(got["program"][k]),
                          "control_min": min(got["control"].get(k, [float("nan")])),
                          "limit": limits.get(k)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
