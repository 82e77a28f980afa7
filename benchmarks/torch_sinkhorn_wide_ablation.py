#!/usr/bin/env python3
"""K1's wide-pair kernel (csrc/sinkhorn.cu, `sinkhorn_wide_kernel`) by variant,
against the PyTorch solver in f64, on one card.

    python3 benchmarks/torch_sinkhorn_wide_ablation.py      # needs one GPU and nvcc

Builds variants of csrc/sinkhorn.cu by text substitution, each into its own
library under build/sinkhorn_wide_ablation/ (one nvcc each, all started
together), and runs chip_smoke.py's wide K1 cases on each through the
wrapper with the wide route forced (`sinkhorn_route` patched), plus the
large-pair kernel on the same inputs (the as-built library, the route forced
to 'large').  The variants:

  as_built      the source as it is;
  other_log     the wide kernel's log-sums by lg2.approx where the source
                takes log2f, or by log2f where it takes lg2.approx (the
                terms by ex2.approx either way);
  accurate_exp  exp2f / log2f in place of every ex2.approx / lg2.approx;
  divide        x / y in place of `div_by` (a product and one correction);
  cluster       the large-pair kernel at `cluster_plan`.

For each case and variant: the largest error of the potentials against
`sinkhorn_solve_plain` at atoms with mass (after the final step), the OT
scores' largest distance from the PyTorch solver in f64 beside the f32
PyTorch solver's (chip_smoke.f64_witness's two numbers, not raised on), and
the milliseconds (median of 20 CUDA-event readings of 5 calls).  One JSON
object a line, then the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the inputs, the timer)
from aspire_tpu_torch.core.types import MultiVec  # noqa: E402
from aspire_tpu_torch.ops import _build, sinkhorn_kernel as sk  # noqa: E402
from aspire_tpu_torch.ops.distances import wasserstein_dist  # noqa: E402

EX2 = ('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "  y = exp2f(x);")
LG2 = ('  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "  y = log2f(x);")
DIV = ("  return fmaf(fmaf(-q, y, x), r, q);", "  return x / y;")
WIDE_LOG = "      const float v = div_by(-(%s(sum) + mx), inv2, r);"
OTHER_LOG = ((WIDE_LOG % "log2f", WIDE_LOG % "lg2")
             if WIDE_LOG % "log2f" in (_build.CSRC / "sinkhorn.cu").read_text()
             else (WIDE_LOG % "lg2", WIDE_LOG % "log2f"))
VARIANTS = {"as_built": (), "other_log": (OTHER_LOG,), "accurate_exp": (EX2, LG2),
            "divide": (DIV,)}
CASES = ((4, 1024, 55), (16, 55, 1024), (20, 20, 800), (160, 20, 800), (16, 48, 40),
         (16, 100, 100), (16, 239, 239))


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
        for fn in ("aspire_sinkhorn_f32", "aspire_sinkhorn_wide_f32",
                   "aspire_sinkhorn_large_f32"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    libs = build(ROOT / "build" / "sinkhorn_wide_ablation")

    def check(err: int, name: str) -> None:
        if err:
            raise RuntimeError(f"launch of {name} failed: error {err}")

    sk._build.check = check
    dev = torch.device("cuda", 0)
    kw = dict(temp=5000.0, return_pair_sims=True, diameter="pair")
    for bsz, n, m in CASES:
        q, c, cost, la, lb, diam, a, b = chip_smoke.sinkhorn_inputs(
            bsz, 7 + bsz + n + m, "pair", dev, n, m)
        fp, gp = sk.sinkhorn_solve_plain(cost, la, lb, diam)
        sims_t, _ = wasserstein_dist(q, c, solver="torch", **kw)
        exact, _ = wasserstein_dist(MultiVec(q.embed.double(), q.lens),
                                    MultiVec(c.embed.double(), c.lens), solver="torch", **kw)
        row = {"case": f"B={bsz} {n}x{m}", "plain_f32_f64_err":
               float((sims_t.double() - exact).abs().max())}
        for name in (*VARIANTS, "cluster"):
            sk._build.load = lambda lib=libs["as_built" if name == "cluster" else name]: lib
            route = "large" if name == "cluster" else "wide"
            sk.sinkhorn_route = lambda *_, route=route: route
            f, g = sk.sinkhorn_solve(cost, la, lb, diam)
            sims_k, _ = wasserstein_dist(q, c, solver="kernel", **kw)
            row[name] = {
                "max_abs_err": max(float((f - fp).abs()[a > 0].max()),
                                   float((g - gp).abs()[b > 0].max())),
                "f64_err": float((sims_k.double() - exact).abs().max()),
                "ms": chip_smoke.cuda_ms(lambda: sk.sinkhorn_solve(cost, la, lb, diam))["median"]}
        print(json.dumps(row), flush=True)
        del q, c, cost
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
