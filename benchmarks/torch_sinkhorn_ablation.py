#!/usr/bin/env python3
"""Takes the Sinkhorn kernel for pairs up to 32 x 32 (K1, csrc/sinkhorn.cu,
`sinkhorn_small_kernel`) apart on one card.

    python3 benchmarks/torch_sinkhorn_ablation.py      # needs one GPU and nvcc

Builds variants of the kernel's source by text substitution, each into its
own library under build/sinkhorn_ablation/, and times them in turns (as
built, the variants, then again in reverse order) on 20 x 20 pairs at B = 16
(a request), B = 30 with grouped diameters in the loop-only mode (a training
step's distance) and B = 1024, each also with the loop cut to one round
(max_iters = 1: the launch, the loads, the first and last rounds).  The
variants:

  no_exponentials  ex2 / lg2 replaced by the identity (wrong results);
  no_exchanges     a round reads the h its own thread published, from a
                   register, with no shared memory and no block barrier: the
                   chain keeps its shape without the exchange (wrong results);
  rounds_alone     both of the above;
  eight_lanes      8 threads a softmin instead of 4 (a design variant);
  accurate_exp     exp2f / log2f in place of ex2.approx / lg2.approx (a
                   design variant).

Each reading is the median of 30 CUDA-event readings of 10 calls.  For the
design variants and the source as built the largest error against the plain
version at atoms with mass is printed too.  One JSON object a line, then the
card's name and power limit.
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
EX2_ACCURATE = (EX2[0], "  y = exp2f(x);")
LG2_ACCURATE = (LG2[0], "  y = log2f(x);")
# a round's reads of h from the thread's own registers, no barrier
OWN_H = ("  auto eps_of = [&]", "  float own = lw2;\n  auto eps_of = [&]")
READS = ("      const float4 v = hp[q];",
         "      const float4 v = make_float4(own, own + 1.f, own - 1.f, own + 2.f);")
PUBLISH = ("""    buf ^= 1;
    if (live) h2[buf][mine][hpos(atom)] = h;
    __syncthreads();""", """    buf ^= 1;
    own = h;""")
EIGHT = ("constexpr int kLanes = 4;", "constexpr int kLanes = 8;")
ASSERT = ('  static_assert(kLanes * 8 == kSmallSide, "the small kernel\'s cases cover 32 atoms");\n',
          "")
EXCHANGES = (OWN_H, READS, PUBLISH)
VARIANTS = {"as_built": (), "no_exponentials": (EX2, LG2),
            "no_exchanges": EXCHANGES, "rounds_alone": (EX2, LG2, *EXCHANGES),
            "eight_lanes": (EIGHT, ASSERT), "accurate_exp": (EX2_ACCURATE, LG2_ACCURATE)}
CHECKED = ("as_built", "eight_lanes", "accurate_exp")
CASES = ((16, "global", True), (30, "grouped", False), (1024, "global", True))


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
        lib.aspire_sinkhorn_f32.argtypes = _build.SIGNATURES["aspire_sinkhorn_f32"]
        lib.aspire_sinkhorn_f32.restype = ctypes.c_int
        libs[name] = lib
        lines = log.splitlines()       # -Xptxas -v: each entry, then its registers
        used = [lines[j].split(":", 1)[1].strip() for i, line in enumerate(lines)
                if "Compiling entry" in line and "sinkhorn_small_kernelILi5E" in line
                for j in range(i + 1, min(i + 4, len(lines))) if "Used" in lines[j]]
        print(json.dumps({"variant": name, "small_kernel_5_ptxas": used[:1]}), flush=True)
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "ab", ROOT / "benchmarks" / "torch_kernel_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    libs = build(ROOT / "build" / "sinkhorn_ablation")

    def check(err: int, name: str) -> None:
        if err:
            raise RuntimeError(f"launch of {name} failed: error {err}")

    sk._build.check = check
    dev = torch.device("cuda", 0)
    for bsz, diameter, extrapolate in CASES:
        q, c, cost, la, lb, diam, a, b = chip_smoke.sinkhorn_inputs(
            bsz, 7 + bsz + 40, diameter, dev)
        fp, gp = sk.sinkhorn_solve_plain(cost, la, lb, diam, extrapolate=extrapolate)
        row = {"batch": bsz, "pairs": "20x20", "diameter": diameter,
               "mode": "extrapolated" if extrapolate else "loop_only",
               "rounds": chip_smoke.sinkhorn_bound(cost, diam)["mean_iters"]}
        for name in CHECKED:
            sk._build.load = lambda lib=libs[name]: lib
            f, g = sk.sinkhorn_solve(cost, la, lb, diam, extrapolate=extrapolate)
            err = max(float((f - fp).abs()[a > 0].max()), float((g - gp).abs()[b > 0].max()))
            row[f"{name}_max_abs_err"] = err
        order = list(libs) + list(reversed(libs))
        for name in order:
            sk._build.load = lambda lib=libs[name]: lib
            for label, iters in (("ms", 128), ("one_round_ms", 1)):
                fn = lambda: sk.sinkhorn_solve(cost, la, lb, diam, max_iters=iters,
                                               extrapolate=extrapolate)
                row.setdefault(f"{name}_{label}", []).append(
                    ab._median_ms(fn)["ms_median"])
        print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
