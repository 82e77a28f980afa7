#!/usr/bin/env python3
"""Takes the large-pair Sinkhorn kernel (K1 past one block's shared memory,
csrc/sinkhorn.cu `sinkhorn_cluster_kernel`) apart on one card.

    python3 benchmarks/torch_sinkhorn_cluster_ablation.py      # needs one GPU and nvcc

Builds variants of the kernel's source by text substitution, each into its
own library under build/sinkhorn_cluster_ablation/, and times them in turns
(as built, the variants, then again in reverse order) at the plan's layout
(`cluster_plan`) on chip_smoke.py's inputs: 16 pairs of 24 x 1,200 (little
work a round) and of 300 x 1,200, and the fused queries' 20 and 160 pairs of
300 x 1,200; each also with the loop cut to one round (max_iters = 1: the
launch, the resident rows' load, three rounds).  The variants, all of them
wrong but for the first:

  as_built         the kernel;
  local_merge      the merge reads its own block's partials and writes h into
                   its own shared memory only (no distributed shared memory;
                   the cluster barriers stay);
  no_cluster       local_merge without the cluster barriers: the rounds' walks
                   and merges alone;
  no_exponentials  ex2 / lg2 replaced by the identity.

Each reading is the median of 30 CUDA-event readings of 10 calls.  One JSON
object a line, then the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the inputs)
from aspire_tpu_torch.ops import _build, sinkhorn_kernel as sk  # noqa: E402

EX2 = ('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "  y = x;")
LG2 = ('  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "  y = x;")
READS = ("pr[r] = cluster.map_shared_rank(o_part, r)[s0 + j];", "pr[r] = o_part[s0 + j];")
WRITES = ("if (r < cn) cluster.map_shared_rank(h_o, r)[s0 + j] = h;",
          "if (r == rank) h_o[s0 + j] = h;")
ARRIVE = ('  asm volatile("barrier.cluster.arrive.release.aligned;\\n" ::: "memory");', "")
WAIT = ('  asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");', "")
VARIANTS = {"as_built": (), "local_merge": (READS, WRITES),
            "no_cluster": (READS, WRITES, ARRIVE, WAIT), "no_exponentials": (EX2, LG2)}
CASES = ((16, 24, 1200), (16, 300, 1200), (20, 300, 1200), (160, 300, 1200))


def build(out_dir: pathlib.Path) -> dict:
    source = (_build.CSRC / "sinkhorn.cu").read_text()
    common = (_build.CSRC / "common.cuh").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "sinkhorn.cu").write_text(text)
        (d / "common.cuh").write_text(common)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "sinkhorn.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / name / "lib.so"))
        for fn in ("aspire_sinkhorn_large_f32", "aspire_sinkhorn_cluster_capacity"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
        lines = log.splitlines()       # -Xptxas -v: each entry, then its registers
        used = [lines[j].split(":", 1)[1].strip() for i, line in enumerate(lines)
                if "Compiling entry" in line and "sinkhorn_cluster_kernel" in line
                for j in range(i + 1, min(i + 4, len(lines))) if "Used" in lines[j]]
        print(json.dumps({"variant": name, "cluster_kernel_ptxas": used[:1]}), flush=True)
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "ab", ROOT / "benchmarks" / "torch_kernel_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    libs = build(ROOT / "build" / "sinkhorn_cluster_ablation")

    def check(err: int, name: str) -> None:
        if err:
            raise RuntimeError(f"launch of {name} failed: error {err}")

    sk._build.check = check
    dev = torch.device("cuda", 0)
    for bsz, n, m in CASES:
        _, _, cost, la, lb, diam, a, b = chip_smoke.sinkhorn_inputs(
            bsz, 7 + bsz + n + m, "pair", dev, n, m)
        fp, gp = sk.sinkhorn_solve_plain(cost, la, lb, diam)
        row = {"batch": bsz, "pairs": f"{n}x{m}", "plan": sk.cluster_plan(bsz, n, m),
               "rounds": chip_smoke.sinkhorn_bound(cost, diam)["mean_iters"]}
        sk._build.load = lambda lib=libs["as_built"]: lib
        f, g = sk.sinkhorn_solve(cost, la, lb, diam)
        row["as_built_max_abs_err"] = max(float((f - fp).abs()[a > 0].max()),
                                          float((g - gp).abs()[b > 0].max()))
        order = list(libs) + list(reversed(libs))
        for name in order:
            sk._build.load = lambda lib=libs[name]: lib
            for label, iters in (("ms", 128), ("one_round_ms", 1)):
                fn = lambda: sk.sinkhorn_solve(cost, la, lb, diam, max_iters=iters)
                row.setdefault(f"{name}_{label}", []).append(
                    ab._median_ms(fn)["ms_median"])
        print(json.dumps(row), flush=True)
        del cost
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
