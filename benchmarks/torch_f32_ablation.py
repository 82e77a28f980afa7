#!/usr/bin/env python3
"""Takes the f32 kernels of the evaluation's encode apart on one card: K2 in
f32 (csrc/attention.cu, `attention_tf32x3_kernel`) and K3 in f32
(csrc/ffn.cu, `split_tf32_kernel` + `ffn_tf32x3_kernel`).

    python3 benchmarks/torch_f32_ablation.py      # needs one GPU and nvcc

Builds variants of each source by text substitution, each into its own
library under build/f32_ablation/, and times them in turns (as built, the
variants, then again in reverse order) at the evaluation's shapes: attention
[8, 12, 512, 64] with padded keys and a fully padded row, the FFN at 4096 rows
of 768 -> 3072 -> 768 (`chip_smoke.py`'s inputs).  The variants:

  attention  one_stage   one K/V stage loaded after each tile and three
                         blocks an SM in place of two stages and two blocks
                         (a design variant);
             hihi_only   the cross terms lo.hi + hi.lo left out: one TF32
                         product, what the split costs (wrong results);
  ffn        launch1_96  launch 1 on 128 x 96 tiles, four stages (a design
                         variant);
             launch2_128 launch 2 on 128 x 128 tiles, three stages (a design
                         variant);
             hihi_only   as above (wrong results).

Each reading is the median of 30 CUDA-event readings of 10 calls.  Every
variant's largest error against the plain version and against an f64
product is printed, and each tf32 kernel's registers and spills from
`-Xptxas -v`.  One JSON object a line, then the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import math
import pathlib
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the inputs)
from aspire_tpu_torch.ops import _build  # noqa: E402
from aspire_tpu_torch.ops import attention_kernel as ak  # noqa: E402
from aspire_tpu_torch.ops import ffn_kernel as fk  # noqa: E402

ONE_STAGE = (("constexpr int kStagesTf32 = 2, kBlocksTf32 = 2;",
              "constexpr int kStagesTf32 = 1, kBlocksTf32 = 3;"),)
ATTN_HIHI = (("  mma_tf32(c, al, bh0, bh1);\n  mma_tf32(c, ah, bl0, bl1);\n", ""),)
FFN_HIHI = (("""        wgmma_tf32<kBn>(part, sw128_desc(a_lo + kk * 8), sw128_desc(b_hi + kk * 8), kk > 0);
        wgmma_tf32<kBn>(part, sw128_desc(a_hi + kk * 8), sw128_desc(b_lo + kk * 8), 1);
""", ""), ("""        wgmma_tf32<kBn>(part, sw128_desc(a_hi + kk * 8), sw128_desc(b_hi + kk * 8), 1);""",
           """        wgmma_tf32<kBn>(part, sw128_desc(a_hi + kk * 8), sw128_desc(b_hi + kk * 8), kk > 0);"""))
VARIANTS = {
    "attention": {"as_built": (), "one_stage": ONE_STAGE, "hihi_only": ATTN_HIHI},
    "ffn": {"as_built": (),
            "launch1_96": (("using Launch1F32 = TileF32<128, 3>;",
                            "using Launch1F32 = TileF32<96, 4>;"),),
            "launch2_128": (("using Launch2F32 = TileF32<96, 4>;",
                             "using Launch2F32 = TileF32<128, 3>;"),),
            "hihi_only": FFN_HIHI},
}
SOURCES = {"attention": "attention.cu", "ffn": "ffn.cu"}
ENTRY = {"attention": "aspire_attention_f32", "ffn": "aspire_ffn_f32"}
EXACT = ("as_built", "one_stage", "launch1_96", "launch2_128")


def build(out_dir: pathlib.Path) -> dict:
    headers = {name: (_build.CSRC / name).read_text()
               for name in ("common.cuh", "attention_tile.cuh")}
    procs = {}
    for kernel, variants in VARIANTS.items():
        source = (_build.CSRC / SOURCES[kernel]).read_text()
        for name, subs in variants.items():
            files = {SOURCES[kernel]: source, **headers}
            for old, new in subs:
                holder = next((f for f, body in files.items() if old in body), None)
                if holder is None:
                    raise RuntimeError(f"{kernel} {name}: the sources no longer hold {old!r}")
                files[holder] = files[holder].replace(old, new)
            d = out_dir / kernel / name
            d.mkdir(parents=True, exist_ok=True)
            for file, body in files.items():
                (d / file).write_text(body)
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
                   str(d / SOURCES[kernel])]
            procs[kernel, name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (kernel, name), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kernel} {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / kernel / name / "lib.so"))
        fn = getattr(lib, ENTRY[kernel])
        fn.argtypes = _build.SIGNATURES[ENTRY[kernel]]
        fn.restype = ctypes.c_int
        libs[kernel, name] = lib
        ptxas = [{"entry": chip_smoke.kernel_entry(m.group(1)), "registers": int(m.group(4)),
                  "spill_stores": int(m.group(2)), "spill_loads": int(m.group(3))}
                 for m in re.finditer(r"Compiling entry function '(\w+)'.*?(\d+) bytes spill "
                                      r"stores, (\d+) bytes spill loads.*?Used (\d+) registers",
                                      log, re.S)
                 if "tf32" in m.group(1)]
        print(json.dumps({"kernel": kernel, "variant": name, "ptxas": ptxas}), flush=True)
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = importlib.util.spec_from_file_location(
        "ab", ROOT / "benchmarks" / "torch_kernel_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    libs = build(ROOT / "build" / "f32_ablation")

    def check(err: int, name: str) -> None:
        if err:
            raise RuntimeError(f"launch of {name} failed: error {err}")

    _build.check = check
    dev = torch.device("cuda", 0)
    q, k, v, bias = chip_smoke.attention_inputs(8, 12, 512, 64, torch.float32, 11 + 512, dev)
    scale = 1.0 / math.sqrt(64)
    rows = slice(0, 7)                  # the rows with a real key (f64 differs on the padded one)
    s64 = q[rows].double() @ k[rows].double().transpose(-1, -2) * scale \
        + bias[rows, None, None, :].double()
    attn = {"fn": lambda: ak.fused_attention(q, k, v, bias, scale),
            "plain": ak.fused_attention_plain(q, k, v, bias, scale),
            "f64": torch.softmax(s64, dim=-1) @ v[rows].double(), "rows": rows,
            "shape": "[8,12,512,64] f32"}
    del s64
    x, w1, b1, w2, b2 = chip_smoke.ffn_inputs(4096, torch.float32, 13 + 4096 + 768, dev)
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    pre = x.double() @ w1.double() + b1.double()
    ffn = {"fn": lambda: fk.fused_ffn_linear(x, w1t, b1, w2t, b2),
           "plain": fk.fused_ffn_plain(x, w1, b1, w2, b2),
           "f64": F.gelu(pre, approximate="none") @ w2.double() + b2.double(),
           "rows": slice(None), "shape": "rows=4096 768->3072->768 f32"}
    del pre
    with torch.inference_mode():
        for kernel, case in (("attention", attn), ("ffn", ffn)):
            names = list(VARIANTS[kernel])
            row = {"kernel": kernel, "shape": case["shape"]}
            for name in names:
                _build.load = lambda lib=libs[kernel, name]: lib
                out = case["fn"]()
                torch.cuda.synchronize()
                row[f"{name}_max_abs_err"] = float((out - case["plain"]).abs().max())
                row[f"{name}_f64_max_abs_err"] = float(
                    (out[case["rows"]].double() - case["f64"]).abs().max())
            for name in names + list(reversed(names)):
                _build.load = lambda lib=libs[kernel, name]: lib
                row.setdefault(f"{name}_ms", []).append(ab._median_ms(case["fn"])["ms_median"])
            if any(row[f"{name}_max_abs_err"] > 1e-4 for name in names if name in EXACT):
                raise AssertionError(f"{kernel}: a design variant is off by more than 1e-4: {row}")
            print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
