#!/usr/bin/env python3
"""Times a kernel of two checkouts of this repo in turns on one card.

    python3 benchmarks/torch_kernel_ab.py --other PATH         # attention forward, p = 0
    python3 benchmarks/torch_kernel_ab.py --other PATH --dropout   # forward, p = 0.1 (K5a)
    python3 benchmarks/torch_kernel_ab.py --other PATH --bwd   # backward (K5b)
    python3 benchmarks/torch_kernel_ab.py --other PATH --ffn   # FFN forward (K3)
    python3 benchmarks/torch_kernel_ab.py --other PATH --sinkhorn   # Sinkhorn (K1)
    python3 benchmarks/torch_kernel_ab.py --other PATH --sinkhorn-large   # K1's large pairs
    python3 benchmarks/torch_kernel_ab.py --other PATH --sinkhorn-wide   # K1's wide pairs
    python3 benchmarks/torch_kernel_ab.py --other PATH --pool   # sentence pool (K4)
    python3 benchmarks/torch_kernel_ab.py --other PATH --scan-int8   # int8 scan (K7)
    python3 benchmarks/torch_kernel_ab.py --other PATH --scan-long   # K8, K7 on full-text buckets
    python3 benchmarks/torch_kernel_ab.py --other PATH --wide   # K2, K5a, K5b at heads of 128-256

PATH is another checkout (for instance the parent commit unpacked with `git
archive` into a directory that .gitignore lists).  Each checkout builds its own
kernels and is measured in its own process, in the order other, this, this,
other; every reading is the median of 30 CUDA-event readings of 10 calls with
the device given a head start, so the host's share of a call is not in it.
The forward reading is `fused_attention` at dropout_p = 0 (K2) in bf16 at
three shapes and in f32 at the evaluation's [8, 12, 512, 64]; the dropout
reading (`--dropout`) is `fused_attention` at dropout_p = 0.1 with the Philox
mask, called on inputs that require a gradient so that the forward leaves its
row statistics as in a training step (K5a), in bf16 and in f32 (the training
shape [30, 12, 512, 64] and [4, 12, 512, 64]); both with the device
milliseconds a call by kernel under torch.profiler beside them.  The backward
reading (`--bwd`) is `torch.autograd.grad` of `fused_attention` at dropout_p =
0.1 (Philox mask) and at 0, which launches the backward kernels alone, in bf16
and in f32 at the same two shapes, with the device milliseconds a call by
kernel under torch.profiler beside it.  The dropout and backward readings
carry `library_ms`, the same call through `scaled_dot_product_attention`
(which draws its own mask), and in f32 the largest error of the forward, or of
dq, dk and dv, against an f64 version fed the same mask (`f64_max_abs_err`).  The
FFN reading (`--ffn`) is the no-grad FFN at 4096 and 16384 rows of 768 -> 3072
-> 768 in bf16 and at 4096 rows in f32, through the entry the checkout's model
calls (`fused_ffn_linear` on [out, in] weights where the checkout has it, else
`fused_ffn` on [in, out] ones), with its device milliseconds by kernel.  The
Sinkhorn reading (`--sinkhorn`) is K1 (f32) on 20 x 20 pairs at B = 16 (a
request), 30 with grouped diameters (a training step's micro batches of 3),
1024 and 2048 (a fused batch of 32 queries at k = 64), and at 48 x 40 and
100 x 100, each after the final step and in the loop-only mode the training
loss uses (a checkout without that mode prints that it refuses it).  The large-pair
reading (`--sinkhorn-large`) is K1 the same way at chip_smoke.py's large
cases -- B = 16 at 24 x 1,200, 300 x 1,200, 240 x 240 and 512 x 512, B = 30
at 300 x 300 with grouped diameters -- then the fused queries' reranks, 20 and
160 pairs of 300 x 1,200, and 16 pairs of 1,200 x 1,200, with a request's
16 pairs of 20 x 20 beside them; a checkout with `cluster_plan` prints the
blocks a pair and resident rows it launches.  The wide-pair reading
(`--sinkhorn-wide`) is K1 the same way at chip_smoke.py's wide cases -- an
abstract's query against 20 and 160 full-text candidates (20 x 800), 48 x 40
at B = 16 and 1,024, 100 x 100, and the route's edges 239 x 239 and 55 x
1,024 at B = 16 -- with the large route's 240 x 240 (the edge's other side)
and a request's 20 x 20 beside them, then single-atom pairs (33 x 1, 1 x
1,024) at B = 4; each case also gives the OT scores' largest distance from
the PyTorch solver in f64, the checkout's kernel route beside its f32
PyTorch solver (chip_smoke.f64_witness's two numbers, printed, not held); a
checkout with `wide_plan` prints the team and threads it launches and the
kernel a batch runs (`sinkhorn_route(n, m, bsz)`).  The pooling reading (`--pool`) is the kernel alone
(`sentence_sums`) at the encode shape [64, 256, 768] in bf16 and f32 with 20
sentences, a request's [16, 256, 768], and [16, 512, 768] with 96 sentences,
which the first kernel refused (a checkout that refuses a shape prints its
error).  The wide reading (`--wide`) is K2, K5a and K5b as above at the ranges
phase's 6 heads of 128 ([16, 6, 256, 128] forward, [30, 6, 512, 128] with
dropout and backward) and at heads of 192 and 256, bf16 and f32 (f32 also at
[4, 6, 512, 128] with dropout and backward, p = 0.1 and 0), with the 64-wide
f32 kernels beside them (K2 [8, 12, 512, 64], K5a and K5b [30, 12, 512, 64]),
which share the wide f32 kernels' code.  The int8 scan reading (`--scan-int8`) is K7
(`fused_l2max_scan_int8_batched`) on buckets of the shapes of the
125,000-document index (clip(poisson(9), 3, 20) sentences, seed 0, buckets 12
and 24: [109440, 12, 768] and [15568, 24, 768]), made on the card from a seed,
at B = 32 and B = 1 with 16 query sentences, B = 5 with 20, and B = 32 with
24 slots holding clip(poisson(9), 3, 20) real sentences (the search cell's
batch), each with its scores' digest (`scores_sha256`: equal digests, equal
scores bit for bit) and its real sentences; the bf16
scan (K8) on the same rows in bf16 at B = 1 beside it.  The long scan reading
(`--scan-long`) is K8 (`fused_l2max_scan`, one query of 300 sentences) and
K7 (a batch of 8 queries of 300) on buckets of the shapes of the ranges
phase's full-text index (2,000 documents of 240-1,200 sentences, numpy seed
45, buckets 400, 800 and 1,200: [368, 400, 768], [800, 800, 768] and [840,
1200, 768]; rows made on the card as above, K8 on them in bf16), then the
`--scan-int8` reading.  The f32 readings (K2
and K3) also give the largest error of the checkout's kernel against an f64
product of the same inputs (`f64_max_abs_err`).
The modes may be combined.  One JSON object a line, a checkout's first
process adds its kernels' registers and spills from the build log
(`ptxas_registers_spill_stores_loads`, mangled names), then the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys

SHAPES = (((16, 12, 256, 64), "bfloat16"), ((4, 12, 512, 64), "bfloat16"),
          ((30, 12, 512, 64), "bfloat16"), ((8, 12, 512, 64), "float32"))
DROPOUT_CASES = (((30, 12, 512, 64), "bfloat16"), ((16, 12, 256, 64), "bfloat16"),
                 ((30, 12, 512, 64), "float32"), ((4, 12, 512, 64), "float32"))
FFN_CASES = ((4096, "bfloat16"), (16384, "bfloat16"), (4096, "float32"))
SINKHORN_CASES = ((16, 20, 20, "global"), (30, 20, 20, "grouped"),
                  (1024, 20, 20, "global"), (2048, 20, 20, "pair"),
                  (16, 48, 40, "pair"), (16, 100, 100, "pair"))
# K1's large pairs: chip_smoke.py's five first cases, then the fused
# queries' reranks (20 and 160 pairs of 300 x 1,200) and 1,200 x 1,200; the
# small pairs of a request beside them
SINKHORN_LARGE_CASES = ((16, 24, 1200, "pair"), (16, 300, 1200, "pair"),
                        (16, 240, 240, "pair"), (16, 512, 512, "pair"),
                        (30, 300, 300, "grouped"), (20, 300, 1200, "pair"),
                        (160, 300, 1200, "pair"), (16, 1200, 1200, "pair"),
                        (16, 20, 20, "global"))
# K1's wide pairs: chip_smoke.py's wide cases, then the large route's 240 x
# 240 and the small route's 20 x 20 beside them
SINKHORN_WIDE_CASES = ((20, 20, 800, "pair"), (160, 20, 800, "pair"),
                       (16, 48, 40, "pair"), (1024, 48, 40, "pair"),
                       (16, 100, 100, "pair"), (16, 239, 239, "pair"),
                       (16, 55, 1024, "pair"), (16, 240, 240, "pair"),
                       (16, 20, 20, "global"), (4, 33, 1, "pair"), (4, 1, 1024, "pair"))
BWD_CASES = tuple((shape, p, dtype) for shape, dtype in (
    ((30, 12, 512, 64), "bfloat16"), ((16, 12, 256, 64), "bfloat16"),
    ((30, 12, 512, 64), "float32"), ((4, 12, 512, 64), "float32")) for p in (0.1, 0.0))
WIDE_CASES = (("forward", (16, 6, 256, 128), 0.0, "bfloat16"),
              ("forward", (4, 4, 512, 192), 0.0, "bfloat16"),
              ("forward", (2, 3, 512, 256), 0.0, "bfloat16"),
              ("forward", (16, 6, 256, 128), 0.0, "float32"),
              ("dropout", (30, 6, 512, 128), 0.1, "bfloat16"),
              ("dropout", (4, 4, 512, 192), 0.1, "bfloat16"),
              ("dropout", (4, 3, 512, 256), 0.1, "bfloat16"),
              ("dropout", (4, 6, 512, 128), 0.1, "float32"),
              ("backward", (30, 6, 512, 128), 0.1, "bfloat16"),
              ("backward", (30, 6, 512, 128), 0.0, "bfloat16"),
              ("backward", (4, 4, 512, 192), 0.1, "bfloat16"),
              ("backward", (4, 3, 512, 256), 0.1, "bfloat16"),
              ("forward", (4, 4, 512, 192), 0.0, "float32"),
              ("forward", (2, 3, 512, 256), 0.0, "float32"),
              ("dropout", (30, 6, 512, 128), 0.1, "float32"),
              ("dropout", (4, 4, 512, 192), 0.1, "float32"),
              ("dropout", (4, 3, 512, 256), 0.1, "float32"),
              ("backward", (4, 6, 512, 128), 0.1, "float32"),
              ("backward", (4, 6, 512, 128), 0.0, "float32"),
              ("backward", (30, 6, 512, 128), 0.1, "float32"),
              ("backward", (4, 4, 512, 192), 0.1, "float32"),
              ("backward", (4, 3, 512, 256), 0.1, "float32"),
              # the 64-wide f32 kernels, whose code the wide ones share
              ("forward", (8, 12, 512, 64), 0.0, "float32"),
              ("dropout", (30, 12, 512, 64), 0.1, "float32"),
              ("backward", (30, 12, 512, 64), 0.1, "float32"))


def _median_ms(fn, calls: int = 10, readings: int = 30) -> dict:
    import torch
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
    return {"ms_median": statistics.median(times), "ms_min": min(times),
            "ms_max": max(times)}


def _digest(scores) -> str:
    """The first 16 hex digits of the SHA-256 of a result's bytes: two
    checkouts' scores equal bit for bit where their digests do."""
    return hashlib.sha256(scores.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def _inputs(b, nh, t, hd, dev, dtype="bfloat16"):
    import numpy as np
    import torch
    rng = np.random.default_rng(t)
    return [torch.from_numpy(rng.standard_normal((b, t, nh, hd)).astype(
        np.float32)).to(dev, getattr(torch, dtype)).permute(0, 2, 1, 3)
        for _ in range(4)]


def _f64_err(got, want64) -> float:
    """Largest absolute error of an f32 result against its f64 product."""
    return float((got.double() - want64).abs().max())


def measure_ffn() -> None:
    import numpy as np
    import torch
    from aspire_tpu_torch.ops import ffn_kernel as fk
    dev = torch.device("cuda", 0)
    for rows, dtype in FFN_CASES:
        rng = np.random.default_rng(rows)
        arr = lambda *shape, scale=1.0: torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(
            dev, getattr(torch, dtype))
        x, w1, b1 = arr(rows, 768), arr(768, 3072, scale=0.02), arr(3072, scale=0.02)
        w2, b2 = arr(3072, 768, scale=0.02), arr(768, scale=0.02)
        if hasattr(fk, "fused_ffn_linear"):
            w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
            fn = lambda: fk.fused_ffn_linear(x, w1t, b1, w2t, b2)
        else:
            fn = lambda: fk.fused_ffn(x, w1, b1, w2, b2)
        extra = {}
        with torch.inference_mode():
            if dtype == "float32":
                pre = x.double() @ w1.double() + b1.double()
                extra["f64_max_abs_err"] = _f64_err(fn(), torch.nn.functional.gelu(
                    pre, approximate="none") @ w2.double() + b2.double())
                del pre
            ms = _median_ms(fn)
            by_kernel = _by_kernel(fn)
        print(json.dumps({"rows": rows, "ffn": "768->3072->768", "dtype": dtype,
                          "kernel": "ffn", **ms, **extra,
                          "device_ms_by_kernel": by_kernel}), flush=True)


def _f64_witness(q, c) -> dict:
    """OT scores of the checkout's kernel route and of its f32 PyTorch
    solver against the PyTorch solver in f64: largest absolute distances."""
    import torch
    from aspire_tpu_torch.core.types import MultiVec
    from aspire_tpu_torch.ops.distances import wasserstein_dist
    kw = dict(temp=5000.0, return_pair_sims=True, diameter="pair")
    with torch.no_grad():
        exact, _ = wasserstein_dist(MultiVec(q.embed.double(), q.lens),
                                    MultiVec(c.embed.double(), c.lens), solver="torch", **kw)
        return {route: float((wasserstein_dist(q, c, solver=solver, **kw)[0].double()
                              - exact).abs().max())
                for route, solver in (("kernel", "kernel"), ("plain_f32", "torch"))}


def measure_sinkhorn(cases=SINKHORN_CASES, witness: bool = False) -> None:
    import inspect
    import torch
    import chip_smoke                   # the checkout's own, on sys.path
    from aspire_tpu_torch.ops import sinkhorn_kernel as sk
    from aspire_tpu_torch.ops.sinkhorn import grouped_max_diameter
    from aspire_tpu_torch.ops.sinkhorn_kernel import sinkhorn_solve
    dev = torch.device("cuda", 0)
    has_loop_only = "extrapolate" in inspect.signature(sinkhorn_solve).parameters
    for bsz, n, m, diameter in cases:
        q, c, cost, la, lb, diam, _, _ = chip_smoke.sinkhorn_inputs(
            bsz, 7 + bsz + n + m, "pair" if diameter == "grouped" else diameter,
            dev, n, m)
        if diameter == "grouped":
            diam = grouped_max_diameter(q.embed, c.embed, bsz // 3)
        for mode in ("extrapolated", "loop_only"):
            row = {"batch": bsz, "pairs": f"{n}x{m}", "diameter": diameter,
                   "mode": mode, "dtype": "float32", "kernel": "sinkhorn",
                   "route": sk.sinkhorn_route(n, m)}
            if row["route"] == "large" and hasattr(sk, "cluster_plan"):
                row["blocks_a_pair"], row["resident_rows"] = sk.cluster_plan(bsz, n, m)
            if row["route"] == "wide" and hasattr(sk, "wide_plan"):
                row["team"], row["threads"] = sk.wide_plan(n, m)
                row["batch_route"] = sk.sinkhorn_route(n, m, bsz)
            if witness and mode == "extrapolated":
                row["f64_max_abs_err"] = _f64_witness(q, c)
            if mode == "loop_only" and not has_loop_only:
                print(json.dumps({**row, "refused": "no loop-only mode"}), flush=True)
                continue
            kw = {} if mode == "extrapolated" else {"extrapolate": False}
            fn = lambda: sinkhorn_solve(cost, la, lb, diam, **kw)
            print(json.dumps({**row, **_median_ms(fn),
                              "device_ms_by_kernel": _by_kernel(fn)}), flush=True)
        del q, c, cost
        torch.cuda.empty_cache()


def measure_sinkhorn_large() -> None:
    measure_sinkhorn(SINKHORN_LARGE_CASES)


def measure_sinkhorn_wide() -> None:
    measure_sinkhorn(SINKHORN_WIDE_CASES, witness=True)


POOL_CASES = ((64, 256, 768, 20, "bfloat16"), (64, 256, 768, 20, "float32"),
              (16, 256, 768, 20, "bfloat16"), (16, 512, 768, 96, "bfloat16"))
SCAN_CASES = ((32, 16), (1, 16), (5, 20), (32, 24))   # 32 x 24: the search cell's batch


def measure_pool() -> None:
    import numpy as np
    import torch
    from aspire_tpu_torch.ops import pool_kernel as pk
    dev = torch.device("cuda", 0)
    for b, t, h, smax, dtype in POOL_CASES:
        rng = np.random.default_rng(t + smax)
        hidden = torch.from_numpy(rng.standard_normal((b, t, h)).astype(
            np.float32)).to(dev, getattr(torch, dtype))
        per = (t - 8) // smax                     # runs after [CLS], a padded tail
        ids = np.full((b, t), -1, np.int64)
        ids[:, 1:1 + per * smax] = np.repeat(np.arange(smax), per)
        ids = torch.from_numpy(ids).to(dev)
        fn = lambda: pk.sentence_sums(hidden, ids, smax)
        row = {"shape": [b, t, h], "sentences": smax, "dtype": dtype,
               "kernel": "pool"}
        try:
            fn()
        except (ValueError, RuntimeError) as exc:
            print(json.dumps({**row, "refused": str(exc)}), flush=True)
            continue
        print(json.dumps({**row, **_median_ms(fn),
                          "device_ms_by_kernel": _by_kernel(fn)}), flush=True)


LONG_BUCKETS = (400, 800, 1200)


def long_lengths():
    """The sentence counts of the ranges phase's full-text index
    (`chip_smoke.build_long_index`: 2,000 documents, numpy seed 45)."""
    import numpy as np
    return np.random.default_rng(45).integers(240, 1201, 2000)


def int8_buckets(dev, lens=None, buckets=(12, 24), d: int = 768):
    """Buckets of the shapes `chip_smoke.build_large_index` gives (or of the
    sentence counts `lens`), made on the card: per-sentence int8 rows and
    scales from a seed, norms of the stored vectors, +inf norms (and zero
    rows) at pads, docs padded to a multiple of 8."""
    import numpy as np
    import torch
    if lens is None:
        lens = np.clip(np.random.default_rng(0).poisson(9, 125_000), 3, 20)
    gen = torch.Generator(device=dev).manual_seed(0)
    out, lo = [], 0
    for s in buckets:
        mine = lens[(lens > lo) & (lens <= s)]
        lo = s
        n = -(-len(mine) // 8) * 8
        doc_len = torch.zeros(n, dtype=torch.int64, device=dev)
        doc_len[:len(mine)] = torch.from_numpy(mine).to(dev)
        live = torch.arange(s, device=dev)[None, :] < doc_len[:, None]
        sents = torch.randint(-127, 128, (n, s, d), generator=gen, device=dev,
                              dtype=torch.int8) * live[:, :, None]
        scales = (0.01 + 0.02 * torch.rand((n, s), generator=gen, device=dev)) * live
        norms = (sents.float() ** 2).sum(dim=2) * scales * scales
        norms = torch.where(live, norms, torch.full_like(norms, float("inf")))
        out.append((sents.contiguous(), scales.contiguous(), norms.contiguous()))
    return out


def measure_scan_int8() -> None:
    import numpy as np
    import torch
    from aspire_tpu_torch.ops import scan_kernel as sk
    dev = torch.device("cuda", 0)
    for sents, scales, norms in int8_buckets(dev):
        n, s, d = sents.shape
        for bsz, qmax in SCAN_CASES:
            rng = np.random.default_rng(bsz + s)
            q = torch.from_numpy(rng.standard_normal((bsz, qmax, d)).astype(
                np.float32) * 2.0).to(dev)
            # 24 slots: an abstract's clip(poisson(9), 3, 20) real sentences
            lens = (np.clip(rng.poisson(9, bsz), 3, 20) if qmax == 24
                    else rng.integers(3, qmax + 1, bsz))
            q_lens = torch.from_numpy(lens).to(dev)
            fn = lambda: sk.fused_l2max_scan_int8_batched(sents, scales, norms, q,
                                                           q_lens, qmax)
            print(json.dumps({"bucket": [n, s, d], "batch": bsz, "qmax": qmax,
                              "real_sentences": int(lens.sum()),
                              "scores_sha256": _digest(fn()),
                              "kernel": "scan_int8", **_median_ms(fn),
                              "device_ms_by_kernel": _by_kernel(fn)}), flush=True)
        rows = sents.to(torch.bfloat16)
        q = torch.from_numpy(np.random.default_rng(s).standard_normal(
            (16, d)).astype(np.float32)).to(dev)
        fn = lambda: sk.fused_l2max_scan(rows, q, norms, 10)
        print(json.dumps({"bucket": [n, s, d], "batch": 1, "qmax": 16,
                          "kernel": "scan_bf16", **_median_ms(fn),
                          "device_ms_by_kernel": _by_kernel(fn)}), flush=True)
        del rows
        torch.cuda.empty_cache()


def measure_scan_long() -> None:
    import numpy as np
    import torch
    from aspire_tpu_torch.ops import scan_kernel as sk
    dev = torch.device("cuda", 0)
    for sents, scales, norms in int8_buckets(dev, long_lengths(), LONG_BUCKETS):
        n, s, d = sents.shape
        rng = np.random.default_rng(300 + s)
        q = torch.from_numpy(rng.standard_normal((8, 300, d)).astype(np.float32) * 2.0).to(dev)
        q_lens = torch.full((8,), 300, dtype=torch.int64, device=dev)
        fn = lambda: sk.fused_l2max_scan_int8_batched(sents, scales, norms, q, q_lens, 300)
        print(json.dumps({"bucket": [n, s, d], "batch": 8, "qmax": 300,
                          "scores_sha256": _digest(fn()),
                          "kernel": "scan_int8", **_median_ms(fn, calls=3, readings=15),
                          "device_ms_by_kernel": _by_kernel(fn, calls=3)}), flush=True)
        rows, q1 = sents.to(torch.bfloat16), q[0]
        qadd = -(q1 * q1).sum(dim=1)
        fn = lambda: sk.fused_l2max_scan(rows, q1, norms, 300, qadd)
        print(json.dumps({"bucket": [n, s, d], "batch": 1, "qmax": 300,
                          "scores_sha256": _digest(fn()),
                          "kernel": "scan_bf16", **_median_ms(fn, calls=3, readings=15),
                          "device_ms_by_kernel": _by_kernel(fn, calls=3)}), flush=True)
        del rows, sents, scales, norms
        torch.cuda.empty_cache()
    measure_scan_int8()


def _attention64(q, k, v, scale, p, keep):
    """The attention in f64 (differentiable), the mask given."""
    import torch
    q, k, v = (x.double() for x in (q, k, v))
    probs = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1)
    if p > 0:
        probs = torch.where(keep, probs / (1.0 - p), 0.0)
    return probs @ v


def _forward(b, nh, t, hd, dtype, dev) -> dict:
    """K2: `fused_attention` at dropout_p = 0, no gradient."""
    import torch
    from aspire_tpu_torch.ops.attention_kernel import fused_attention
    q, k, v, _ = _inputs(b, nh, t, hd, dev, dtype)
    bias = torch.zeros((b, t), device=dev)
    fn = lambda: fused_attention(q, k, v, bias, 1.0 / math.sqrt(hd))
    extra = {}
    with torch.inference_mode():
        if dtype == "float32":
            s64 = q.double() @ k.double().transpose(-1, -2) / math.sqrt(hd)
            extra["f64_max_abs_err"] = _f64_err(
                fn(), torch.softmax(s64, dim=-1) @ v.double())
            del s64
        ms = _median_ms(fn)
        by_kernel = _by_kernel(fn)
    return {"shape": [b, nh, t, hd], "dtype": dtype, **ms, **extra,
            "device_ms_by_kernel": by_kernel}


def _dropout(b, nh, t, hd, dtype, dev) -> dict:
    """K5a: `fused_attention` at dropout_p = 0.1 on inputs that require a
    gradient (the forward leaves its row statistics)."""
    import torch
    import torch.nn.functional as F
    from aspire_tpu_torch.ops.attention_kernel import (attention_keep_mask,
                                                       fused_attention)
    q, k, v, _ = _inputs(b, nh, t, hd, dev, dtype)
    bias = torch.zeros((b, t), device=dev)
    scale = 1.0 / math.sqrt(hd)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    fn = lambda: fused_attention(*leaves, bias, scale, 0.1, seed=7, site=1)
    extra = {}
    if dtype == "float32":
        keep = attention_keep_mask(q.shape, 0.1, seed=7, site=1, device=dev)
        with torch.no_grad():
            extra["f64_max_abs_err"] = _f64_err(
                fn(), _attention64(q, k, v, scale, 0.1, keep))
        del keep
    library = _median_ms(lambda: F.scaled_dot_product_attention(
        *leaves, dropout_p=0.1, scale=scale))["ms_median"]
    return {"shape": [b, nh, t, hd], "dtype": dtype, "kernel": "forward",
            "dropout_p": 0.1, **_median_ms(fn), "library_ms": library, **extra,
            "device_ms_by_kernel": _by_kernel(fn)}


def _backward(b, nh, t, hd, p, dtype, dev) -> dict:
    """K5b: `torch.autograd.grad` of `fused_attention` (Philox mask)."""
    import torch
    import torch.nn.functional as F
    from aspire_tpu_torch.ops.attention_kernel import (attention_keep_mask,
                                                       fused_attention)
    q, k, v, g = _inputs(b, nh, t, hd, dev, dtype)
    bias = torch.zeros((b, t), device=dev)
    scale = 1.0 / math.sqrt(hd)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    out = fused_attention(*leaves, bias, scale, p, seed=7, site=1)
    fn = lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)
    extra = {}
    if dtype == "float32":
        keep = (attention_keep_mask(q.shape, p, seed=7, site=1, device=dev)
                if p > 0 else None)
        leaves64 = [x.detach().double().requires_grad_(True) for x in (q, k, v)]
        want = torch.autograd.grad(_attention64(*leaves64, scale, p, keep),
                                   leaves64, g.double())
        extra["f64_max_abs_err"] = max(_f64_err(got, ref)
                                       for got, ref in zip(fn(), want))
        del keep, leaves64, want
    ms = _median_ms(fn)
    out_l = F.scaled_dot_product_attention(*leaves, dropout_p=p, scale=scale)
    library = _median_ms(lambda: torch.autograd.grad(
        out_l, leaves, g, retain_graph=True))["ms_median"]
    del out_l
    return {"shape": [b, nh, t, hd], "dtype": dtype, "kernel": "backward",
            "dropout_p": p, **ms, "library_ms": library, **extra,
            "device_ms_by_kernel": _by_kernel(fn)}


def measure(bwd: bool, dropout: bool) -> None:
    import torch
    dev = torch.device("cuda", 0)
    if dropout:
        for shape, dtype in DROPOUT_CASES:
            print(json.dumps(_dropout(*shape, dtype, dev)), flush=True)
    elif not bwd:
        for shape, dtype in SHAPES:
            print(json.dumps(_forward(*shape, dtype, dev)), flush=True)
    else:
        for shape, p, dtype in BWD_CASES:
            print(json.dumps(_backward(*shape, p, dtype, dev)), flush=True)


def measure_wide() -> None:
    """The wide heads: K2, K5a and K5b at the ranges phase's shapes (6 heads
    of 128) and at 192 and 256, bf16 and f32, and the 64-wide f32 kernels."""
    import torch
    dev = torch.device("cuda", 0)
    for kind, shape, p, dtype in WIDE_CASES:
        if kind == "forward":
            row = _forward(*shape, dtype, dev)
        elif kind == "dropout":
            row = _dropout(*shape, dtype, dev)
        else:
            row = _backward(*shape, p, dtype, dev)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()


def _by_kernel(fn, calls: int = 10) -> dict:
    """Device milliseconds a call by kernel name, under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "#" not in e.name:
            # a template's first argument tells apart the launches of one kernel
            found = re.search(r"(\w+_kernel)(<\d+)?", e.name)
            name = "".join(filter(None, found.groups())) if found else e.name[:40]
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / calls
    return out


def _ptxas() -> dict:
    """Registers and spill bytes of each kernel of the checkout's library,
    from its build log (empty when this process loaded a library built
    before)."""
    from aspire_tpu_torch.ops import _build
    out = {}
    for m in re.finditer(r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, "
                         r"(\d+) bytes spill loads.*?Used (\d+) registers",
                         _build.build_log, re.S):
        out[m.group(1)] = [int(m.group(4)), int(m.group(2)), int(m.group(3))]
    return {"ptxas_registers_spill_stores_loads": out}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", help="another checkout of the repo")
    parser.add_argument("--bwd", action="store_true",
                        help="time the backward (K5b) instead of the forward")
    parser.add_argument("--dropout", action="store_true",
                        help="time the forward with dropout (K5a) instead")
    parser.add_argument("--ffn", action="store_true",
                        help="time the FFN forward (K3) instead")
    parser.add_argument("--sinkhorn", action="store_true",
                        help="time the Sinkhorn solver (K1) instead")
    parser.add_argument("--sinkhorn-large", action="store_true",
                        help="time K1's large pairs (and 20 x 20 beside them) instead")
    parser.add_argument("--sinkhorn-wide", action="store_true",
                        help="time K1's wide pairs (240 x 240 and 20 x 20 beside them)")
    parser.add_argument("--pool", action="store_true",
                        help="time the sentence-pool sums (K4) instead")
    parser.add_argument("--scan-int8", action="store_true",
                        help="time the int8 batched scan (K7) instead")
    parser.add_argument("--scan-long", action="store_true",
                        help="time K8 and K7 on full-text buckets, then as --scan-int8")
    parser.add_argument("--wide", action="store_true",
                        help="time K2, K5a and K5b at heads of 128 to 256 instead")
    parser.add_argument("--measure", action="store_true",
                        help="measure the checkout on sys.path (internal)")
    args = parser.parse_args()
    modes = {"ffn": measure_ffn, "sinkhorn": measure_sinkhorn,
             "sinkhorn_large": measure_sinkhorn_large,
             "sinkhorn_wide": measure_sinkhorn_wide,
             "pool": measure_pool, "scan_int8": measure_scan_int8,
             "scan_long": measure_scan_long, "wide": measure_wide}
    if args.measure:
        chosen = [fn for name, fn in modes.items() if getattr(args, name)]
        for fn in chosen:
            fn()
        if not chosen:
            measure(args.bwd, args.dropout)
        print(json.dumps(_ptxas()), flush=True)
        return 0
    this = pathlib.Path(__file__).resolve().parent.parent
    other = pathlib.Path(args.other).resolve()
    argv = ["ab", "--measure"] + [
        "--" + flag.replace("_", "-")
        for flag in ("bwd", "dropout", "ffn", "sinkhorn", "sinkhorn_large",
                     "sinkhorn_wide", "pool",
                     "scan_int8", "scan_long", "wide")
        if getattr(args, flag)]
    for label, root in (("other", other), ("this", this), ("this", this),
                        ("other", other)):
        code = (f"import sys; sys.path.insert(0, {str(root)!r}); "
                f"sys.argv = {argv!r}; "
                f"exec(open({str(pathlib.Path(__file__).resolve())!r}).read())")
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, cwd=root)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        for line in out.stdout.splitlines():
            print(json.dumps({"checkout": label, **json.loads(line)}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
