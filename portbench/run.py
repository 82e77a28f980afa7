#!/usr/bin/env python3
"""The benchmark of aspire_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the package.  Needs a CUDA
device (exits 2 without one).  The last line of standard output is the
result as one JSON object; the last lines of standard error are the numbers
that decide `correct`, each beside its limit.  See portbench/README.md.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # kernel caches at fixed places inside the checkout (the program's own
    # nvcc build lands in build/aspire_tpu_torch/)
    cache = ROOT / "build" / "portbench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))

    import torch
    from portbench.lib.cell import cell_spec, run_cell

    spec = cell_spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"{args.workload} needs {spec['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(2)          # one process, few host threads: steadier runs
    seed = args.seed & (2**64 - 1)
    result = run_cell(args.workload, seed, args.seconds, bool(args.trace), device,
                      T_START)
    print(f"card: {card()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


if __name__ == "__main__":
    sys.exit(main())
