#!/usr/bin/env python3
"""Where the CUDA FFN kernel of aspire_tpu_torch spends its time.

    python3 benchmarks/torch_ffn_ablation.py        # needs one GPU and nvcc

Builds `aspire_tpu_torch/csrc/ffn.cu` as it is and in variants with one part
taken out (the weight loads after the first stages, the tensor-core math, one
of the two products, the activation), and times the bf16 kernel at 4096 and
1024 rows of a 768 -> 3072 -> 768 FFN with CUDA events.  The variants compute
wrong results on purpose; only their times mean anything.  One JSON object a
line: {"variant", "rows", "ms"} (median of 10 readings of 5 launches), then
the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "aspire_tpu_torch" / "csrc"

# (variant, [(text in ffn.cu, replacement)]): each takes one part out
EDITS = {
    "as_is": [],
    "no_loads": [("    if (g < total && producer) {", "    if (g < kStages && producer) {")],
    "no_math": [("      math.first(s, xs, slot);", "      if (rows < 0) math.first(s, xs, slot);"),
                ("      math.second(s - s1, hs, slot);", "      if (rows < 0) math.second(s - s1, hs, slot);")],
    "no_first_product": [("      math.first(s, xs, slot);", "      if (rows < 0) math.first(s, xs, slot);")],
    "no_second_product": [("      math.second(s - s1, hs, slot);", "      if (rows < 0) math.second(s - s1, hs, slot);")],
    "no_activation": [("      if (s == s1 - 1) math.activate(b1 + chunk * kFc, hs);",
                       "      if (s == s1 - 1 && rows < 0) math.activate(b1 + chunk * kFc, hs);")],
}


def build_all(out: pathlib.Path) -> dict:
    from aspire_tpu_torch.ops import _build
    source = (CSRC / "ffn.cu").read_text()
    procs = {}
    for name, edits in EDITS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: ffn.cu no longer holds {old!r}")
            text = text.replace(old, new)
        cu, so = out / f"ffn_{name}.cu", out / f"ffn_{name}.so"
        cu.write_text(text)
        flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *flags, "-I", str(CSRC), "-o", str(so), str(cu)]))
    libs = {}
    for name, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on variant {name}")
        fn = ctypes.CDLL(str(so)).aspire_ffn_bf16
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen) * scale).to(bf16)

    x, w1, b1 = rand(4096, 768), rand(768, 3072, scale=0.02), rand(3072, scale=0.02)
    w2, b2 = rand(3072, 768, scale=0.02), rand(768, scale=0.02)
    y = torch.empty_like(x)
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in build_all(pathlib.Path(tmp)).items():
            for rows in (4096, 1024):
                def launch():
                    err = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                             b2.data_ptr(), y.data_ptr(), rows, 768, 3072,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"launch failed with CUDA error {err}")
                for _ in range(3):
                    launch()
                torch.cuda.synchronize()
                times = []
                for _ in range(10):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(5):
                        launch()
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end) / 5)
                print(json.dumps({"variant": name, "rows": rows,
                                  "ms": statistics.median(times)}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
