#!/usr/bin/env python3
"""Takes the bf16 attention forward (csrc/attention.cu) apart on one card.

    python3 benchmarks/torch_attention_ablation.py      # needs one GPU and nvcc

Builds three copies of the kernel side by side into build/attention_ablation/:
the source as it is, one without its elementwise work (the row statistics of
pass 1 and the probabilities, mask and cast of pass 2 replaced by a cast of
the raw scores: what is left is the walk of loads, barriers and products),
and one that stops loading once the ring of stages is full (every later step
reads the tiles already there: the walk without its loads).  The copies'
outputs are meaningless; only their times are read.  Each is called through
its own library at [30, 12, 512, 64] with and without dropout (p = 0.1,
Philox) and at [16, 12, 256, 64] without, in turns (as built, ablations, then
the reverse), each reading the median of 30 CUDA-event readings of 10 calls
with the device given a head start.  One JSON object a line, then the card's
name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import math
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from aspire_tpu_torch.ops import _build, attention_kernel as ak  # noqa: E402

SRC = _build.CSRC / "attention.cu"
OUT = ROOT / "build" / "attention_ablation"
CASES = (((30, 12, 512, 64), 0.1), ((30, 12, 512, 64), 0.0), ((16, 12, 256, 64), 0.0))

_ELEMENTWISE_START = "#pragma unroll\n    for (int c = 0; c < kN; ++c) {        // 8-column accumulator tile c"
_ELEMENTWISE_END = "    const bf16* vt = ring"


def _without_elementwise(src: str) -> str:
    stats = "    row_stats<kN>(s, m_run, l_run);\n"
    if stats not in src:
        raise ValueError("attention.cu changed: no row_stats call to replace")
    src = src.replace(stats, "    m_run[0] = fmaxf(m_run[0], s[0]);\n    l_run[1] += s[7];\n")
    i, j = src.index(_ELEMENTWISE_START), src.index(_ELEMENTWISE_END)
    return src[:i] + """#pragma unroll
    for (int c = 0; c < kN; ++c) {
      pa[c >> 1][2 * (c & 1)] = pack_bf16(s[4 * c], s[4 * c + 1]);
      pa[c >> 1][2 * (c & 1) + 1] = pack_bf16(s[4 * c + 2], s[4 * c + 3]);
    }
""" + src[j:]


def _without_loads(src: str) -> str:
    head = "  auto load_step = [&](int s) {\n"
    if head not in src:
        raise ValueError("attention.cu changed: no load_step to cut")
    return src.replace(head, head + "    if (s >= kStagesW) return;\n")


VARIANTS = {"as built": lambda s: s, "no elementwise work": _without_elementwise,
            "no loads past the ring": _without_loads}


def build() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    src = SRC.read_text()
    for i, (name, patch) in enumerate(VARIANTS.items()):
        cu, so = OUT / f"attention_{i}.cu", OUT / f"attention_{i}.so"
        cu.write_text(patch(src))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(so)).aspire_attention_bf16
        fn.argtypes = _build.SIGNATURES["aspire_attention_bf16"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _call(fn, q, k, v, bias, out, p, stats):
    b, nh, t, hd = q.shape
    strides = [*ak._strides(q), *ak._strides(k), *ak._strides(v), *ak._strides(out)]
    mode, seed, c0, thresh, plane0, keep_div, _, bits = ak._drop_args(q, p, 7, 1, None, 0)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
             b, nh, t, hd, *strides, 1.0 / math.sqrt(hd), mode, seed, c0, thresh, plane0, keep_div,
             bits,
             stats.data_ptr() if p else 0, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: error {err}")


def _median_ms(fn, calls: int = 10, readings: int = 30) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(readings):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(3_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    fns = build()
    dev = torch.device("cuda", 0)
    order = list(fns) + list(fns)[::-1]
    for (b, nh, t, hd), p in CASES:
        gen = torch.Generator(device=dev).manual_seed(t)
        q, k, v = (torch.randn((b, t, nh, hd), generator=gen, device=dev)
                   .to(torch.bfloat16).permute(0, 2, 1, 3) for _ in range(3))
        bias = torch.zeros((b, t), device=dev)
        out = torch.empty_like(q)
        stats = torch.empty((3, b * nh, t), device=dev)
        ms = {name: [] for name in fns}
        for name in order:
            ms[name].append(_median_ms(lambda: _call(fns[name], q, k, v, bias, out, p, stats)))
        print(json.dumps({"shape": [b, nh, t, hd], "dtype": "bfloat16", "dropout_p": p,
                          "ms": ms}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
