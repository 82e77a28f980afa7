#!/usr/bin/env python3
"""Takes the wide int8 scan (K7, csrc/scan_int8.cu on int8 rows) apart on one card.

    python3 benchmarks/torch_scan_int8_ablation.py      # needs one GPU and nvcc

Builds variants of the kernel's source by text substitution, each into its
own library under build/scan_int8_ablation/, and times them in turns (as
built, the variants, then again in reverse order) on the two buckets of the
125,000-document index (`torch_kernel_ab.int8_buckets`) at B = 32 queries of
16 sentences.  The variants are timing probes; their results are wrong:

  no_epilogue   the row maxima and the per-document pass skipped;
  no_products   the wgmma products skipped (rows still loaded and converted);
  rows_only     the rows' path alone: TMA into the ring and the barriers, no
                shared-memory reads of the rows, no products, no epilogue.

Each reading is the median of 15 CUDA-event readings of 5 calls.  One JSON
object a line, then the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from aspire_tpu_torch.ops import _build, scan_kernel as sk  # noqa: E402

EPILOGUE = ("      for (int h = 0; h < 2; ++h) {\n#pragma unroll\n        for (int p = 0;",
            "      for (int h = 0; h < (acc[0] == 1234.5f ? 2 : 0); ++h) {\n"
            "#pragma unroll\n        for (int p = 0;")
DOC_PASS = ("i < ((e - 1) / S - d0 + 1) * qg;", "i < 0;")
PRODUCTS = ("      wgmma_m64n128k16<0>(acc, cur[j], sw128_desc(qc + j * 16), c > 0 || j > 0);",
            "      if (cur[j][0] == 0x12345678u)\n"
            "        wgmma_m64n128k16<0>(acc, cur[j], sw128_desc(qc + j * 16), c > 0 || j > 0);")
ROW_READS = ("    lo = *reinterpret_cast<const uint4*>(src);\n"
             "    hi = *reinterpret_cast<const uint4*>(src + 8 * kRowBytes);",
             "    lo = make_uint4(s, 0, 0, 0);\n    hi = lo;")
VARIANTS = {"as_built": (), "no_epilogue": (EPILOGUE, DOC_PASS),
            "no_products": (PRODUCTS,),
            "rows_only": (ROW_READS, PRODUCTS, EPILOGUE, DOC_PASS)}


def build(out_dir: pathlib.Path) -> dict:
    source = (_build.CSRC / "scan_int8.cu").read_text()
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
        (d / "scan_int8.cu").write_text(text)
        (d / "common.cuh").write_text(common)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "scan_int8.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / name / "lib.so"))
        lib.aspire_scan_int8_wide.argtypes = _build.SIGNATURES["aspire_scan_int8_wide"]
        lib.aspire_scan_int8_wide.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "ab", ROOT / "benchmarks" / "torch_kernel_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    libs = build(ROOT / "build" / "scan_int8_ablation")

    def check(err: int, name: str) -> None:
        if err:
            raise RuntimeError(f"launch of {name} failed: error {err}")

    sk._build.check = check
    dev = torch.device("cuda", 0)
    for sents, scales, norms in ab.int8_buckets(dev):
        n, s, d = sents.shape
        rng = np.random.default_rng(32 + s)
        q = torch.from_numpy(rng.standard_normal((32, 16, d)).astype(np.float32) * 2).to(dev)
        q_lens = torch.from_numpy(rng.integers(3, 17, 32)).to(dev)
        qn = (q * q).sum(dim=2)
        qadd = torch.where(torch.arange(16, device=dev)[None] < q_lens[:, None], -qn,
                           torch.full_like(qn, sk.NEG))
        row = {"bucket": [n, s, d], "batch": 32, "qmax": 16}
        order = list(libs) + list(reversed(libs))
        for name in order:
            sk._build.load = lambda lib=libs[name]: lib
            fn = lambda: sk._launch("aspire_scan_int8", sents, scales, norms, q, qadd)
            row.setdefault(f"{name}_ms", []).append(
                ab._median_ms(fn, calls=5, readings=15)["ms_median"])
        print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
