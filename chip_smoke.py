#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's serving, training and index paths on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, needs one card and nvcc
    python3 chip_smoke.py --layers 2 --train-layers 2    # quicker, same widths
    python3 chip_smoke.py --phases index --index-docs 20000   # the index path alone
    python3 chip_smoke.py --phases kernels   # every kernel against its plain version, alone

Phases run in the order device, build, kernels, serve, train, index.

Phases, one JSON object a line:

  device   the card (name and power limit as nvidia-smi prints them) and the
           torch / CUDA / nvcc / triton versions;
  build    nvcc builds aspire_tpu_torch/csrc/*.cu into one shared library;
  kernels  each CUDA kernel against its plain PyTorch version on the card, at
           the shapes the serving and training paths give it and a few more,
           with times; the dropout kernels with the bits given and with the
           bits made in the kernel (masks equal to ops/philox.py's);
  serve    full-width BERT-base ConSent encode (bf16, 12 layers, weights from
           a numpy seed) of 16 abstracts x 256 tokens, then an OT rerank of
           document 0 against all 16; three requests; the same requests
           through the plain path (naive attention and FFN, PyTorch solver);
           then once more in f32 at two layers;
  index    the path from a corpus to an answered query.  A bf16 and an int8
           dense-bucket index of 125,000 documents (clip(poisson(9), 3, 20)
           sentences of 768-d reps, buckets (12, 24), numpy seed 0) are built
           by build_dense_index on the host and put on the card; the scan
           kernels are held against their plain versions on its buckets.
           Then, with the launch counts at 0: 512 synthetic abstracts through
           encode_corpus (12-layer bf16 ConSentEncoder, batches of 64 x 256
           tokens, 20 sentences; once with f32 reps out, once quantised to
           int8 on the card), a bf16 and a prequantised int8 index of them,
           saved, loaded, and queried with a document's own sentences; on the
           large index a single fused query on bf16 (k=50) and on int8 (k=64),
           a batch of 32 on int8 (k=64) and a pool ranking of 8 queries x 512
           ids.  After the counts are read, the same through the plain route
           (scan='torch', solver='torch'), compared, and the stages timed;
  train    full-width BERT-base ts+otAspire model (sbalisentbienc, bf16 over
           f32 parameters, weights from a numpy seed): the first step's loss
           and gradient norms through the kernels against the plain path fed
           the same Philox masks (the same model, superbatch and seed as the
           step that follows); then Trainer.train for four
           optimizer steps on superbatches [10, 3, 512] with one wide encode
           a side, a dev-loss check on a batch with explicit negatives, the
           checkpoint restored into a fresh model, the full state saved,
           restored and one more step taken; then one step of the sequential
           accumulation path at two layers.

Any failed check raises: the run then prints {"ok": false, ...} and exits
with code 1.  Without CUDA it exits with code 1 before printing any result.
The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# Published peaks of one H100 SXM (NVIDIA data sheet; dense, at 700 W).
PEAK_BYTES = 3.35e12          # device memory, bytes/s
PEAK_BF16 = 989e12            # tensor cores, FLOP/s
PEAK_FP32 = 67e12             # FP32 lanes outside the tensor cores, FLOP/s
# exp/log go through the special-function units: 16 an SM against 128 FP32
# lanes, each of which counts 2 FLOP in PEAK_FP32 -> PEAK_FP32 / 2 / 8 calls/s.
PEAK_SFU = PEAK_FP32 / 2 / 8

REPEATS, WARMUP, INNER = 20, 3, 5


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


HEAD_START_CYCLES = 2_000_000      # about a millisecond of device spinning


def cuda_ms(fn) -> dict:
    """Median / min / max milliseconds of fn() by CUDA events: REPEATS
    readings of INNER back-to-back calls each, after WARMUP calls.  Before
    each reading the device is kept spinning for about a millisecond, so that
    the host has the INNER launches queued when the first event fires and the
    reading is the device's time, not the wrapper's time on the host."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HEAD_START_CYCLES)
        start.record()
        for _ in range(INNER):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / INNER)
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times)}


def check_close(name, got, want, atol, rtol=0.0, mask=None) -> dict:
    got, want = got.float(), want.float()
    if mask is not None:
        got, want = got[mask], want[mask]
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs()
    bound = atol + rtol * want.abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-6)).max())
    if not bool((err <= bound).all()):
        raise AssertionError(f"{name}: max abs err {max_abs} exceeds atol "
                             f"{atol} + rtol {rtol}")
    return {"max_abs_err": max_abs, "max_rel_err": max_rel, "atol": atol,
            "rtol": rtol}


def check_norm(name, got, want, rel: float, abs_of_max: float) -> dict:
    """Holds a whole tensor: the error's norm over the reference's norm, and
    the largest error as a share of the reference's largest value."""
    got, want = got.float(), want.float()
    err = got - want
    norm_rel = float(err.norm() / want.norm())
    max_abs, peak = float(err.abs().max()), float(want.abs().max())
    if not (norm_rel <= rel and max_abs <= abs_of_max * peak):
        raise AssertionError(f"{name}: error norm {norm_rel} of the reference's "
                             f"(limit {rel}), max abs err {max_abs} of a largest "
                             f"value {peak} (limit {abs_of_max} of it)")
    return {"norm_rel_err": norm_rel, "max_abs_err": max_abs,
            "max_abs_of_max": max_abs / peak}


def bound(bytes_moved: float, ops: float, peak_ops: float) -> dict:
    by_bytes = bytes_moved / PEAK_BYTES * 1e3
    by_ops = ops / peak_ops * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": bytes_moved, "operations": ops}


# --------------------------------------------------------------------- device
def phase_device() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    from aspire_tpu_torch.ops import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-2:]
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    print(smi, flush=True)
    info = {"card": smi, "python": sys.version.split()[0],
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": " | ".join(nvcc), "triton": triton_version,
            "capability": list(torch.cuda.get_device_capability(0))}
    emit("device", **info)


# ---------------------------------------------------------------------- build
def phase_build() -> None:
    from aspire_tpu_torch.ops import _build
    _build.load()
    kernels = []
    for m in re.finditer(
            r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, "
            r"(\d+) bytes spill loads.*?Used (\d+) registers", _build.build_log,
            re.S):
        kernels.append({"entry": m.group(1)[:48], "registers": int(m.group(4)),
                        "spill_stores": int(m.group(2)),
                        "spill_loads": int(m.group(3))})
    emit("build", seconds=_build.build_seconds,
         sources=[str(p.relative_to(_build.CSRC.parent.parent))
                  for p in _build.sources()],
         flags=" ".join(_build.NVCC_FLAGS), ptxas=kernels)


# -------------------------------------------------------------------- kernels
def sinkhorn_inputs(bsz: int, seed: int, diameter: str, dev):
    """The scoring shape of the pair bench: 20 x 20 sentences, 768-d, lens
    4..20, temp 5000 -> (cost, log_a, log_b, diam, a, b)."""
    from aspire_tpu_torch.core.types import MultiVec
    from aspire_tpu_torch.ops.cdist import pairwise_l2
    from aspire_tpu_torch.ops.distances import ot_marginals
    from aspire_tpu_torch.ops.sinkhorn import log_weights, resolve_diameter
    rng = np.random.default_rng(seed)
    smax, d = 20, 768

    def side():
        lens = rng.integers(4, smax + 1, bsz)
        emb = rng.standard_normal((bsz, smax, d)).astype(np.float32) * 2.0
        emb *= (np.arange(smax)[None, :] < lens[:, None])[:, :, None]
        return MultiVec(torch.from_numpy(emb).to(dev),
                        torch.from_numpy(lens).to(dev))

    q, c = side(), side()
    cost = pairwise_l2(q.embed, c.embed)
    a, b, _ = ot_marginals(q, c, temp=5000.0, cost=cost)
    diam = resolve_diameter(q.embed, c.embed, a, b, diameter, None).contiguous()
    return q, c, cost, log_weights(a), log_weights(b), diam, a, b


def sinkhorn_bound(cost, diam, blur=0.05, scaling=0.9, max_iters=128) -> dict:
    bsz, n, m = cost.shape
    ratio = torch.log(blur / diam.clamp_min(1e-30)) / math.log(scaling)
    iters = (torch.ceil(ratio.clamp_min(0.0)) + 2.0).clamp_max(max_iters)
    rounds = float((iters + 2.0).sum())         # + the init and the final step
    calls = rounds * (2 * n * m + n + m)        # exp per cell twice, log per atom
    moved = 4.0 * (bsz * n * m + 2 * bsz * (n + m) + bsz)
    out = bound(moved, calls, PEAK_SFU)
    out["mean_iters"] = float(iters.mean())
    return out


def case_sinkhorn(bsz: int, diameter: str, dev) -> dict:
    from aspire_tpu_torch.ops import sinkhorn_kernel as sk
    from aspire_tpu_torch.ops.distances import wasserstein_dist
    q, c, cost, la, lb, diam, a, b = sinkhorn_inputs(bsz, 7 + bsz, diameter, dev)
    f, g = sk.sinkhorn_solve(cost, la, lb, diam)
    torch.cuda.synchronize()
    fp, gp = sk.sinkhorn_solve_plain(cost, la, lb, diam)
    # potentials mean something only at atoms with mass; f32 on both sides,
    # other summation order and exp/log routines over ~70 compounding rounds
    tol = dict(atol=1e-3, rtol=1e-3)
    res = check_close("sinkhorn f", f, fp, mask=a > 0, **tol)
    res_g = check_close("sinkhorn g", g, gp, mask=b > 0, **tol)
    res = {k: max(res[k], res_g[k]) for k in res}
    kw = dict(temp=5000.0, return_pair_sims=True, diameter=diameter)
    sims_k, (_, _, _, plan_k, _) = wasserstein_dist(q, c, solver="kernel", **kw)
    sims_t, (_, _, _, plan_t, _) = wasserstein_dist(q, c, solver="torch", **kw)
    sims = check_close("sinkhorn sims", sims_k, sims_t, atol=2e-3, rtol=2e-3)
    plan = check_close("sinkhorn plan", plan_k, plan_t, atol=2e-3, rtol=0.0)
    res.update(sims_max_abs_err=sims["max_abs_err"],
               plan_max_abs_err=plan["max_abs_err"])
    t_k = cuda_ms(lambda: sk.sinkhorn_solve(cost, la, lb, diam))
    t_p = cuda_ms(lambda: sk.sinkhorn_solve_plain(cost, la, lb, diam))
    res.update(case=f"B={bsz} n=m=20 f32 diameter={diameter}",
               kernel_ms=t_k, plain_ms=t_p, library_ms=None,
               pairs_per_s=bsz / t_k["median"] * 1e3,
               **sinkhorn_bound(cost, diam))
    return res


def attention_inputs(b, nh, t, hd, dtype, seed, dev):
    rng = np.random.default_rng(seed)
    # laid out as the model has them: [b, t, nh, hd] projections viewed as
    # [b, nh, t, hd]
    q, k, v = (torch.from_numpy(
        rng.standard_normal((b, t, nh, hd)).astype(np.float32)
    ).to(dev, dtype).permute(0, 2, 1, 3) for _ in range(3))
    keep = np.ones((b, t), bool)
    for row in range(1, b, 2):                  # padded keys in every other row
        keep[row, int(rng.integers(t // 4, t)):] = False
    keep[b - 1, :] = False                      # one fully padded row
    bias = torch.from_numpy(np.where(keep, 0.0, -1e9).astype(np.float32)).to(dev)
    return q, k, v, bias


def case_attention(b, nh, t, hd, dtype, dev) -> dict:
    from aspire_tpu_torch.ops import attention_kernel as ak
    q, k, v, bias = attention_inputs(b, nh, t, hd, dtype, 11 + t, dev)
    scale = 1.0 / math.sqrt(hd)
    out = ak.fused_attention(q, k, v, bias, scale)
    torch.cuda.synchronize()
    want = ak.fused_attention_plain(q, k, v, bias, scale)
    # bf16: the context is rounded to bf16 once on each side, so they differ
    # by at most an ulp or two (2^-8 relative) of O(1) values.  f32: other
    # summation order and expf routine.
    tol = dict(atol=2e-2) if dtype == torch.bfloat16 else dict(atol=1e-4)
    res = check_close("attention", out, want, **tol)
    uniform = v[b - 1].float().mean(dim=1, keepdim=True).expand(-1, t, -1)
    check_close("attention, fully padded row", out[b - 1], uniform,
                atol=2e-2 if dtype == torch.bfloat16 else 1e-4)
    mask = bias[:, None, None, :].to(dtype)
    size = q.element_size()
    res.update(
        case=f"[{b},{nh},{t},{hd}] {str(dtype).split('.')[-1]}",
        kernel_ms=cuda_ms(lambda: ak.fused_attention(q, k, v, bias, scale)),
        plain_ms=cuda_ms(lambda: ak.fused_attention_plain(q, k, v, bias, scale)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale)),
        **bound(4.0 * b * nh * t * hd * size + 4.0 * b * t,
                4.0 * b * nh * t * t * hd,
                PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32))
    return res


def _tol(dtype) -> float:
    """bf16: outputs are rounded to bf16 once on each side, so they differ by
    an ulp or two (2^-8 relative) of O(1) values.  f32: other summation order
    and expf routine."""
    return 2e-2 if dtype == torch.bfloat16 else 1e-4


# K5b as a whole against the plain version in f32 on the same inputs: the
# error's norm over the reference's, and the largest error over the
# reference's largest value (check_norm).  bf16 rounds pd, ds and the outputs
# to 8 bits and reads 2e-3 to 4e-3 and 4e-3 to 6e-3; a backward without the
# 1 / (1 - p) of dprobs reads 0.10 in dq and dk, one without delta 0.16 and
# 0.10 (bwd_sensitivity measures both in every run).
BWD_NORM_TOL = {torch.bfloat16: {"rel": 1e-2, "abs_of_max": 1e-2},
                torch.float32: {"rel": 2e-6, "abs_of_max": 2e-6}}


def _random_bits(shape, seed, dev):
    """uint32 bits from numpy, as the int32 pattern the kernels read."""
    bits = np.random.default_rng(seed).integers(0, 2 ** 32, shape, dtype=np.uint32)
    return torch.from_numpy(bits.view(np.int32)).to(dev)


def case_attention_dropout(b, nh, t, hd, dtype, dev, p=0.1, site=3) -> dict:
    """K5a: the forward with dropout against its plain version, with the
    bits given and with the bits made in the kernel (plain version fed by
    ops/philox.py: the masks must be equal)."""
    from aspire_tpu_torch.ops import attention_kernel as ak
    q, k, v, bias = attention_inputs(b, nh, t, hd, dtype, 17 + t, dev)
    scale, seed = 1.0 / math.sqrt(hd), 0x1234_5678_9ABC_DEF0 + t
    tol = _tol(dtype)
    # in-kernel Philox: v = identity-like probe recovers the mask exactly
    keep = ak.attention_keep_mask(q.shape, p, seed=seed, site=site, device=dev)
    out = ak.fused_attention(q, k, v, bias, scale, p, seed=seed, site=site)
    torch.cuda.synchronize()
    want = ak.fused_attention_plain(q, k, v, bias, scale, p, keep)
    res = check_close("attention_dropout (philox)", out, want, atol=tol)
    again = ak.fused_attention(q, k, v, bias, scale, p, seed=seed, site=site)
    if not torch.equal(out, again):
        raise AssertionError("attention_dropout: same seed, different output")
    other = ak.fused_attention(q, k, v, bias, scale, p, seed=seed + 1, site=site)
    if torch.equal(out, other):
        raise AssertionError("attention_dropout: other seed, same output")
    # the mask itself: one-hot values pick out the kept keys of 64 columns
    eye = torch.zeros_like(v)
    cols = torch.arange(min(t, hd), device=dev)
    eye[:, :, cols, cols] = 1.0
    probe = ak.fused_attention(q, k, eye, torch.zeros_like(bias), scale, p,
                               seed=seed, site=site)
    got_keep = probe[..., :len(cols)] != 0
    want_keep = keep[..., :len(cols)]
    probs_pos = ak.fused_attention(q, k, eye, torch.zeros_like(bias), scale)[
        ..., :len(cols)] != 0                 # a probability can underflow bf16
    if not torch.equal(got_keep & probs_pos, want_keep & probs_pos):
        raise AssertionError("attention_dropout: kernel mask != philox mask")
    keep_rate = float(keep.float().mean())
    if keep.numel() >= 10 ** 7 and abs(keep_rate - (1 - p)) > 1e-3:
        raise AssertionError(f"attention_dropout: keep rate {keep_rate}")
    # explicit bits
    bits = _random_bits((b, nh, t, t), 23 + t, dev)
    keep_b = ak.attention_keep_mask(q.shape, p, rng_bits=bits)
    out_b = ak.fused_attention(q, k, v, bias, scale, p, rng_bits=bits)
    res_b = check_close("attention_dropout (bits)", out_b,
                        ak.fused_attention_plain(q, k, v, bias, scale, p, keep_b),
                        atol=tol)
    mask = bias[:, None, None, :].to(dtype)
    size = q.element_size()
    res.update(
        case=f"[{b},{nh},{t},{hd}] {str(dtype).split('.')[-1]} p={p}",
        bits_max_abs_err=res_b["max_abs_err"], keep_rate=keep_rate,
        masks_equal=True,
        kernel_ms=cuda_ms(lambda: ak.fused_attention(
            q, k, v, bias, scale, p, seed=seed, site=site)),
        plain_ms=cuda_ms(lambda: ak.fused_attention_plain(
            q, k, v, bias, scale, p, keep)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=p, scale=scale)),
        **bound(4.0 * b * nh * t * hd * size + 4.0 * b * t,
                4.0 * b * nh * t * t * hd,
                PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32))
    return res


def case_attention_bwd(b, nh, t, hd, dtype, dev, p=0.1, site=3) -> dict:
    """K5b: dq, dk, dv against autograd of the plain version, with the bits
    given and made in the kernel; p = 0 differentiates the deterministic
    forward.  Each gradient is held twice: element by element against the
    plain version in the same dtype, and as a whole (error norm over reference
    norm, largest error over largest value) against the plain version run in
    f32 on the same inputs, which is what catches a wrong factor: typical
    gradient entries are far below the element check's absolute part.
    `bwd_sensitivity` reads what two such faults give under the second."""
    from aspire_tpu_torch.ops import attention_kernel as ak
    q, k, v, bias = attention_inputs(b, nh, t, hd, dtype, 19 + t, dev)
    g = torch.from_numpy(np.random.default_rng(29 + t).standard_normal(
        (b, t, nh, hd)).astype(np.float32)).to(dev, dtype).permute(0, 2, 1, 3)
    scale, seed = 1.0 / math.sqrt(hd), 0x0FED_CBA9_8765_4321 + t
    # gradients are sums of up to t products of O(1) values rounded to bf16
    # once; the plain version's autograd rounds at other places (its dprobs
    # passes through bf16), so bf16 gets a relative part as well
    tol = dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16 \
        else dict(atol=1e-4, rtol=1e-4)

    def grads(fn):
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        fn(*leaves).backward(g)
        return [x.grad for x in leaves]

    def grads_f32(keep_):
        leaves = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
        ak.fused_attention_plain(*leaves, bias, scale, p, keep_).backward(g.float())
        return [x.grad for x in leaves]

    worst = {"max_abs_err": 0.0, "max_rel_err": 0.0, "norm_rel_err": 0.0,
             "max_abs_err_f32_ref": 0.0, "max_abs_of_max_f32_ref": 0.0}
    norm_tol = BWD_NORM_TOL[dtype]

    def compare(label, got, want, ref):
        for name, a_, w_, r_ in zip(("dq", "dk", "dv"), got, want, ref):
            r = check_close(f"attention_bwd {label} {name}", a_, w_, **tol)
            n = check_norm(f"attention_bwd {label} {name} against f32", a_, r_,
                           **norm_tol)
            for key, val in (("max_abs_err", r["max_abs_err"]),
                             ("max_rel_err", r["max_rel_err"]),
                             ("norm_rel_err", n["norm_rel_err"]),
                             ("max_abs_err_f32_ref", n["max_abs_err"]),
                             ("max_abs_of_max_f32_ref", n["max_abs_of_max"])):
                worst[key] = max(worst[key], val)

    if p > 0:
        keep = ak.attention_keep_mask(q.shape, p, seed=seed, site=site, device=dev)
        kernel = lambda q_, k_, v_: ak.fused_attention(
            q_, k_, v_, bias, scale, p, seed=seed, site=site)
        got = grads(kernel)
        torch.cuda.synchronize()
        compare("philox", got, grads(lambda q_, k_, v_: ak.fused_attention_plain(
            q_, k_, v_, bias, scale, p, keep)), grads_f32(keep))
        # the backward's mask is the forward's: with a cotangent of ones in
        # query row 0 only, dv of key j is pd[0, j] in every column -- zero
        # exactly where the forward dropped (or the key is padding)
        row = torch.zeros_like(g)
        row[:, :, 0, :] = 1.0
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        kernel(*leaves).backward(row)
        dv_zero = (leaves[2].grad.float().abs().sum(-1) == 0)      # [b, nh, t]
        dropped = ~keep[:, :, 0, :]
        pad = (bias < 0)[:, None, :].expand_as(dropped)
        if not torch.equal(dv_zero | pad, dropped | pad):
            raise AssertionError("attention_bwd: backward mask != forward mask")
        bits = _random_bits((b, nh, t, t), 31 + t, dev)
        keep_b = ak.attention_keep_mask(q.shape, p, rng_bits=bits)
        compare("bits", grads(lambda q_, k_, v_: ak.fused_attention(
            q_, k_, v_, bias, scale, p, rng_bits=bits)),
            grads(lambda q_, k_, v_: ak.fused_attention_plain(
                q_, k_, v_, bias, scale, p, keep_b)), grads_f32(keep_b))
    else:
        kernel = lambda q_, k_, v_: ak.fused_attention(q_, k_, v_, bias, scale)
        got = grads(kernel)
        torch.cuda.synchronize()
        compare("p=0", got, grads(lambda q_, k_, v_: ak.fused_attention_plain(
            q_, k_, v_, bias, scale)), grads_f32(None))
    again = grads(kernel)
    if not all(torch.equal(a_, b_) for a_, b_ in zip(got, again)):
        raise AssertionError("attention_bwd: two runs differ")

    mask = bias[:, None, None, :].to(dtype)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    out_k = kernel(*leaves)
    out_p = ak.fused_attention_plain(*leaves, bias, scale, p,
                                     keep if p > 0 else None)
    out_l = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                           dropout_p=p, scale=scale)

    def bwd_ms(out):
        return cuda_ms(lambda: torch.autograd.grad(out, leaves, g,
                                                   retain_graph=True))

    size = q.element_size()
    res = dict(worst, atol=tol["atol"], rtol=tol["rtol"],
               norm_rel_limit=norm_tol["rel"],
               max_abs_limit_of_max=norm_tol["abs_of_max"])
    res.update(
        case=f"[{b},{nh},{t},{hd}] {str(dtype).split('.')[-1]} p={p}",
        kernel_ms=bwd_ms(out_k), plain_ms=bwd_ms(out_p),
        library_ms=bwd_ms(out_l),
        # reads q, k, v, g, the forward's output and two floats a row,
        # writes dq, dk, dv; five products of 2 t t hd
        **bound(8.0 * b * nh * t * hd * size + 4.0 * b * t + 8.0 * b * nh * t,
                10.0 * b * nh * t * t * hd,
                PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32))
    return res


def bwd_sensitivity(dev, b=4, nh=12, t=512, hd=64, p=0.1) -> dict:
    """What `check_norm` reads for a backward with a fault, on the inputs of
    the bf16 case of this shape: the backward's formulas written out in f32
    PyTorch, right and with one term left out, against autograd of the plain
    version in f32.  Fails unless each fault reads above the bf16 limit."""
    from aspire_tpu_torch.ops import attention_kernel as ak
    q, k, v, bias = (x.float() for x in attention_inputs(
        b, nh, t, hd, torch.bfloat16, 19 + t, dev))
    g = torch.from_numpy(np.random.default_rng(29 + t).standard_normal(
        (b, t, nh, hd)).astype(np.float32)).to(dev, torch.bfloat16).permute(
        0, 2, 1, 3).float()
    scale = 1.0 / math.sqrt(hd)
    keep = ak.attention_keep_mask(q.shape, p, seed=5, site=3, device=dev)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    ak.fused_attention_plain(*leaves, bias, scale, p, keep).backward(g)
    ref = [x.grad for x in leaves]

    def backward(inv_keep: float, with_delta: bool):
        probs = torch.softmax(q @ k.transpose(-1, -2) * scale
                              + bias[:, None, None, :], dim=-1)
        pd = torch.where(keep, probs / (1.0 - p), 0.0)
        dprobs = torch.where(keep, (g @ v.transpose(-1, -2)) * inv_keep, 0.0)
        delta = (dprobs * probs).sum(-1, keepdim=True) if with_delta else 0.0
        ds = probs * (dprobs - delta) * scale
        return ds @ k, ds.transpose(-1, -2) @ q, pd.transpose(-1, -2) @ g

    def reads(got):
        return {n: float((a_ - r_).norm() / r_.norm())
                for n, a_, r_ in zip(("dq", "dk", "dv"), got, ref)}

    out = {"right": reads(backward(1.0 / (1.0 - p), True)),
           "without_1_over_keep_prob": reads(backward(1.0, True)),
           "without_delta": reads(backward(1.0 / (1.0 - p), False))}
    limit = BWD_NORM_TOL[torch.bfloat16]["rel"]
    if max(out["right"].values()) > 2e-6 or any(
            min(out[f]["dq"], out[f]["dk"]) <= 2 * limit
            for f in ("without_1_over_keep_prob", "without_delta")):
        raise AssertionError(f"attention_bwd: the norm check at {limit} does "
                             f"not tell a faulty backward apart: {out}")
    return dict(out, case=f"[{b},{nh},{t},{hd}] f32 formulas p={p}",
                norm_rel_limit=limit)


def case_dropout(rows, h, dtype, dev, p=0.1, site=7) -> dict:
    """K6: exact against the plain version in both modes, forward and
    backward; keep rate; same seed, same output."""
    from aspire_tpu_torch.ops import dropout_kernel as dk
    x = torch.from_numpy(np.random.default_rng(37 + rows).standard_normal(
        (rows, h)).astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy(np.random.default_rng(41 + rows).standard_normal(
        (rows, h)).astype(np.float32)).to(dev, dtype)
    seed = 0x5EED_0000_0000_0001 + rows
    keep = dk.keep_mask(x.shape, p, seed=seed, site=site, device=dev)
    xr = x.clone().requires_grad_(True)
    out = dk.fused_dropout(xr, p, seed=seed, site=site)
    out.backward(g)
    torch.cuda.synchronize()
    diffs = []

    def differs(got, want) -> bool:
        diffs.append(check_close("dropout", got, want, atol=0.0))
        return not torch.equal(got, want)

    if differs(out.detach(), dk.dropout_plain(x, keep, p)):
        raise AssertionError("dropout: kernel != plain version (philox)")
    if differs(xr.grad, dk.dropout_plain(g, keep, p)):
        raise AssertionError("dropout: backward != plain version (philox)")
    if not torch.equal(out.detach(), dk.fused_dropout(x, p, seed=seed, site=site)):
        raise AssertionError("dropout: same seed, different output")
    if torch.equal(out.detach(), dk.fused_dropout(x, p, seed=seed, site=site + 1)):
        raise AssertionError("dropout: other site, same mask")
    keep_rate = float(keep.float().mean())
    if keep.numel() >= 10 ** 7 and abs(keep_rate - (1 - p)) > 1e-3:
        raise AssertionError(f"dropout: keep rate {keep_rate}")
    bits = _random_bits((rows, h), 43 + rows, dev)
    keep_b = dk.keep_mask(x.shape, p, rng_bits=bits)
    xr = x.clone().requires_grad_(True)
    out_b = dk.fused_dropout(xr, p, rng_bits=bits)
    out_b.backward(g)
    if differs(out_b.detach(), dk.dropout_plain(x, keep_b, p)) \
            or differs(xr.grad, dk.dropout_plain(g, keep_b, p)):
        raise AssertionError("dropout: kernel != plain version (bits)")
    size = x.element_size()
    xl = x.clone().requires_grad_(True)
    out_l = F.dropout(xl, p, training=True)
    return dict(
        max_abs_err=max(d["max_abs_err"] for d in diffs),
        max_rel_err=max(d["max_rel_err"] for d in diffs), atol=0.0, rtol=0.0,
        case=f"[{rows},{h}] {str(dtype).split('.')[-1]} p={p}",
        keep_rate=keep_rate, masks_equal=True,
        kernel_ms=cuda_ms(lambda: dk.fused_dropout(x, p, seed=seed, site=site)),
        plain_ms=cuda_ms(lambda: dk.dropout_plain(x, keep, p)),
        library_ms=cuda_ms(lambda: F.dropout(x, p, training=True)),
        library_bwd_ms=cuda_ms(lambda: torch.autograd.grad(
            out_l, xl, g, retain_graph=True)),
        **bound(2.0 * rows * h * size, 1.0 * rows * h, PEAK_FP32))


def ffn_inputs(rows, dtype, seed, dev, h=768, f=3072):
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev, dtype)

    return (arr(rows, h), arr(h, f, scale=0.02), arr(f, scale=0.02),
            arr(f, h, scale=0.02), arr(h, scale=0.02))


def case_ffn(rows, dtype, dev) -> dict:
    from aspire_tpu_torch.ops import ffn_kernel as fk
    x, w1, b1, w2, b2 = ffn_inputs(rows, dtype, 13 + rows, dev)
    out = fk.fused_ffn(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    want = fk.fused_ffn_plain(x, w1, b1, w2, b2)
    # bf16: one rounding of the activation and one of the output a side; a
    # flipped activation ulp moves an O(0.3) output by far less than 2e-2.
    # f32: sums of 768 and 3072 terms in another order.
    tol = dict(atol=2e-2) if dtype == torch.bfloat16 else dict(atol=1e-4)
    res = check_close("ffn", out, want, **tol)
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()      # [out, in]
    h, f = w1.shape
    size = x.element_size()
    res.update(
        case=f"rows={rows} {h}->{f}->{h} {str(dtype).split('.')[-1]}",
        kernel_ms=cuda_ms(lambda: fk.fused_ffn(x, w1, b1, w2, b2)),
        plain_ms=cuda_ms(lambda: fk.fused_ffn_plain(x, w1, b1, w2, b2)),
        library_ms=cuda_ms(lambda: F.linear(
            F.gelu(F.linear(x, w1t, b1), approximate="none"), w2t, b2)),
        **bound(size * (2.0 * rows * h + 2.0 * h * f + h + f),
                4.0 * rows * h * f,
                PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32))
    return res


def case_pool(b, t, h, max_sents, dtype, dev, ragged=False) -> dict:
    """K4 against the one-hot product.  Regular: sentences in runs after
    [CLS], a padded tail.  Ragged: ids drawn at random with gaps, -1 and ids
    past max_sents."""
    from aspire_tpu_torch.ops import pool_kernel as pk
    rng = np.random.default_rng(47 + b + t)
    hidden = torch.from_numpy(rng.standard_normal((b, t, h)).astype(
        np.float32)).to(dev, dtype)
    if ragged:
        ids = rng.integers(-1, max_sents + 2, (b, t))
        ids[ids == 3] = -1                      # sentence 3 has no token
    else:
        per = max(1, (t - 8) // max_sents)
        ids = np.full((b, t), -1, np.int64)
        ids[:, 1:1 + per * max_sents] = np.repeat(np.arange(max_sents), per)
    ids = torch.from_numpy(ids).to(dev)
    out = pk.sentence_pool_fused(hidden, ids, max_sents)
    torch.cuda.synchronize()
    want = pk.sentence_pool_plain(hidden, ids, max_sents)
    # both sides add the same f32 values (bf16 inputs are exact in f32), the
    # kernel in token order, the product in cuBLAS's: means of up to t values
    # of O(1) differ by a few f32 roundings
    res = check_close("pool", out, want, atol=1e-5, rtol=1e-5)
    if not torch.equal(out, pk.sentence_pool_fused(hidden, ids, max_sents)):
        raise AssertionError("pool: two launches differ")
    one_hot = pk._one_hot(ids, max_sents).transpose(1, 2).contiguous()
    hf = hidden.float()
    size = hidden.element_size()
    res.update(
        case=f"[{b},{t},{h}] {str(dtype).split('.')[-1]} {max_sents} sentences"
             + (" ragged ids" if ragged else ""),
        kernel_ms=cuda_ms(lambda: pk.sentence_sums(hidden, ids, max_sents)),
        wrapper_ms=cuda_ms(lambda: pk.sentence_pool_fused(hidden, ids, max_sents)),
        plain_ms=cuda_ms(lambda: pk.sentence_pool_plain(hidden, ids, max_sents)),
        library_ms=cuda_ms(lambda: torch.matmul(one_hot, hf)),
        # reads hidden and the ids, writes the sums; one add a token element
        **bound(size * b * t * h + 4.0 * b * t + 4.0 * b * max_sents * h,
                1.0 * b * t * h, PEAK_FP32))
    return res


def _scan_queries(bsz, qmax, seed, dev):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((bsz, qmax, 768)).astype(
        np.float32) * 2.0).to(dev)
    q_lens = torch.from_numpy(rng.integers(3, qmax + 1, bsz)).to(dev)
    if bsz == 1:
        q_lens[:] = 10
    return q, q_lens


def case_scan_bf16(bucket, label, dev, qmax=16, q_n=10) -> dict:
    """K8 on one bf16 bucket, as the TPU kernel computes it (no qadd) and as
    the index needs it (qadd = -|q_j|^2 inside the max)."""
    from aspire_tpu_torch.ops import scan_kernel as sk
    sents, norms = bucket["sents"], bucket["norms"]
    n, s, d = sents.shape
    q = _scan_queries(1, qmax, 53 + s, dev)[0][0]
    qadd = -(q * q).sum(dim=1)
    live = bucket["doc_idx"] >= 0
    # bf16 operands are exact in f32 on both sides; sums of 768 products of
    # O(4) values in another order, against scores of O(1e3)
    tol = dict(atol=1e-2, rtol=1e-4)
    got = sk.fused_l2max_scan(sents, q, norms, q_n)
    torch.cuda.synchronize()
    want = sk.fused_l2max_scan_plain(sents, q, norms, q_n)
    res = check_close("scan_bf16", got, want, mask=live, **tol)
    if not bool((got[~live] <= sk.NEG).all()):
        raise AssertionError("scan_bf16: a padded document scored")
    got_q = sk.fused_l2max_scan(sents, q, norms, q_n, qadd)
    res_q = check_close("scan_bf16 qadd", got_q,
                        sk.fused_l2max_scan_plain(sents, q, norms, q_n, qadd),
                        mask=live, **tol)
    qb = q.to(torch.bfloat16)

    def library():
        sims = torch.einsum("nsd,qd->nsq", sents, qb[:q_n]).float()
        return (2.0 * sims - norms[:, :, None]).amax(dim=(1, 2))

    res.update(
        case=f"{label}: [{n},{s},{d}] bf16, {q_n} of {qmax} query sentences",
        qadd_max_abs_err=res_q["max_abs_err"],
        kernel_ms=cuda_ms(lambda: sk.fused_l2max_scan(sents, q, norms, q_n, qadd)),
        plain_ms=cuda_ms(lambda: sk.fused_l2max_scan_plain(sents, q, norms, q_n, qadd)),
        library_ms=cuda_ms(library),
        **bound(2.0 * n * s * d + 4.0 * n * s + 2.0 * qmax * d + 4.0 * n,
                2.0 * n * s * d * qmax, PEAK_BF16))
    return res


def case_scan_int8(bucket, label, bsz, dev, qmax=16) -> dict:
    """K7 on one int8 bucket against its plain version."""
    from aspire_tpu_torch.ops import scan_kernel as sk
    sents, scales, norms = bucket["sents"], bucket["scales"], bucket["norms"]
    n, s, d = sents.shape
    q, q_lens = _scan_queries(bsz, qmax, 59 + bsz + s, dev)
    live = bucket["doc_idx"] >= 0
    got = sk.fused_l2max_scan_int8_batched(sents, scales, norms, q, q_lens, qmax)
    torch.cuda.synchronize()
    chunk = 8                                   # bounds the plain [rows, B qmax] f32
    want = torch.cat([sk.fused_l2max_scan_int8_batched_plain(
        sents, scales, norms, q[i:i + chunk], q_lens[i:i + chunk], qmax)
        for i in range(0, bsz, chunk)], dim=1)
    # int8 and bf16 operands are exact in f32 on both sides; sums of 768
    # products in another order, times a scale, against scores of O(1e3)
    res = check_close("scan_int8", got[live], want[live], atol=1e-2, rtol=2e-4)
    if not bool((got[~live] <= 0.5 * sk.NEG).all()):
        raise AssertionError("scan_int8: a padded document scored")
    qb = q.to(torch.bfloat16).reshape(bsz * qmax, d)
    rows_b = sents.reshape(n * s, d)

    def library():
        out = []
        for i in range(0, bsz, chunk):
            cols = qb[i * qmax:(i + chunk) * qmax]
            sims = torch.matmul(rows_b.to(torch.bfloat16), cols.t()).float()
            sc = 2.0 * scales.reshape(-1, 1) * sims - norms.reshape(-1, 1)
            out.append(sc.reshape(n, s, -1, qmax).amax(dim=(1, 3)))
        return torch.cat(out, dim=1)

    res.update(
        case=f"{label}: [{n},{s},{d}] int8, B={bsz} qmax={qmax}",
        kernel_ms=cuda_ms(lambda: sk.fused_l2max_scan_int8_batched(
            sents, scales, norms, q, q_lens, qmax)),
        plain_ms=cuda_ms(lambda: [sk.fused_l2max_scan_int8_batched_plain(
            sents, scales, norms, q[i:i + chunk], q_lens[i:i + chunk], qmax)
            for i in range(0, bsz, chunk)]),
        library_ms=cuda_ms(library),
        **bound(1.0 * n * s * d + 8.0 * n * s + 2.0 * bsz * qmax * d
                + 4.0 * n * bsz, 2.0 * n * s * d * bsz * qmax, PEAK_BF16))
    return res


def phase_kernels(dev) -> dict:
    """Runs every case; the first case of each kernel is its main path's shape
    (serving for the first three, training for the rest) and feeds the
    contract line.  Attention [3,12,512,64] and the FFN at 1536 rows are what
    the training path's dev check gives the deterministic kernels."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = {
        "sinkhorn": [case_sinkhorn(16, "global", dev),
                     case_sinkhorn(50, "global", dev),
                     case_sinkhorn(1024, "global", dev),
                     case_sinkhorn(1024, "pair", dev)],
        "attention": [case_attention(16, 12, 256, 64, bf16, dev),
                      case_attention(3, 12, 512, 64, bf16, dev),
                      case_attention(4, 12, 512, 64, bf16, dev),
                      case_attention(16, 12, 256, 64, f32, dev),
                      case_attention(4, 12, 512, 64, f32, dev),
                      case_attention(2, 12, 200, 64, bf16, dev)],
        "ffn": [case_ffn(4096, bf16, dev), case_ffn(1536, bf16, dev),
                case_ffn(4059, bf16, dev),
                case_ffn(1024, bf16, dev),
                case_ffn(4096, f32, dev), case_ffn(1001, f32, dev)],
        # the training shape first: 30 sequences of 512 tokens an encode
        "attention_dropout": [
            case_attention_dropout(30, 12, 512, 64, bf16, dev),
            case_attention_dropout(16, 12, 256, 64, bf16, dev),
            case_attention_dropout(4, 12, 512, 64, bf16, dev),
            case_attention_dropout(2, 12, 200, 64, bf16, dev),
            case_attention_dropout(4, 12, 512, 64, f32, dev),
            case_attention_dropout(2, 12, 200, 64, f32, dev)],
        "attention_bwd": [
            case_attention_bwd(30, 12, 512, 64, bf16, dev),
            case_attention_bwd(30, 12, 512, 64, bf16, dev, p=0.0),
            case_attention_bwd(16, 12, 256, 64, bf16, dev),
            case_attention_bwd(4, 12, 512, 64, bf16, dev),
            case_attention_bwd(2, 12, 200, 64, bf16, dev),
            case_attention_bwd(2, 12, 200, 64, bf16, dev, p=0.0),
            case_attention_bwd(4, 12, 512, 64, f32, dev),
            case_attention_bwd(2, 12, 200, 64, f32, dev),
            case_attention_bwd(2, 12, 200, 64, f32, dev, p=0.0)],
        "dropout": [case_dropout(15360, 768, bf16, dev),
                    case_dropout(15360, 768, f32, dev),
                    case_dropout(1001, 768, bf16, dev)],
    }
    for name, rows in cases.items():
        emit("kernel_cases", kernel=name, cases=rows)
    emit("attention_bwd_sensitivity", **bwd_sensitivity(dev))
    return cases


def phase_pool_kernel(dev) -> list:
    """K4 against its plain version; the first case is the encode's shape."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [case_pool(64, 256, 768, 20, bf16, dev),
             case_pool(64, 256, 768, 20, f32, dev),
             case_pool(3, 200, 768, 20, bf16, dev, ragged=True),
             case_pool(3, 200, 768, 20, f32, dev, ragged=True),
             case_pool(16, 512, 768, 24, bf16, dev)]
    emit("kernel_cases", kernel="pool", cases=cases)
    return cases


# ---------------------------------------------------------------------- serve
def random_flax_tree(cfg, seed: int) -> dict:
    """ConSentEncoder weights in the Flax tree's layout, from a numpy seed."""
    rng = np.random.default_rng(seed)
    h, f = cfg.hidden_size, cfg.intermediate_size

    def normal(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    def dense(i, o):
        return {"kernel": normal(i, o), "bias": normal(o)}

    def norm():
        return {"scale": 1.0 + normal(h), "bias": normal(h)}

    bert = {"embeddings": {
        "word_embeddings": {"embedding": normal(cfg.vocab_size, h)},
        "position_embeddings": {"embedding": normal(cfg.max_position_embeddings, h)},
        "token_type_embeddings": {"embedding": normal(cfg.type_vocab_size, h)},
        "LayerNorm": norm()}}
    for i in range(cfg.num_hidden_layers):
        bert[f"layer_{i}"] = {
            "attention_self": {"query": dense(h, h), "key": dense(h, h),
                               "value": dense(h, h)},
            "attention_output_dense": dense(h, h),
            "attention_output_LayerNorm": norm(),
            "intermediate_dense": dense(h, f),
            "output_dense": dense(f, h),
            "output_LayerNorm": norm()}
    return {"bert": bert}


def make_request(cfg, seed: int, dev, docs=16, tokens=256, max_sents=20,
                 sent_tokens=12):
    """16 abstracts: document j is document 0 with its last j sentences either
    replaced by other tokens (j < 8) or missing and padded (j >= 8), so the
    true ranking against document 0 is graded.  Token 0 is [CLS]; the tail
    past the last sentence is padding."""
    rng = np.random.default_rng(seed)
    body = 1 + max_sents * sent_tokens
    base = rng.integers(5, cfg.vocab_size, tokens)
    token_ids = np.tile(base, (docs, 1))
    attn_mask = np.zeros((docs, tokens), np.int64)
    sent_ids = np.full((docs, tokens), -1, np.int64)
    abs_lens = np.zeros(docs, np.int64)
    for j in range(docs):
        keep = max_sents - j
        n_sents = max_sents if j < 8 else keep
        end = 1 + n_sents * sent_tokens
        cut = 1 + keep * sent_tokens
        if 0 < j < 8:
            token_ids[j, cut:body] = rng.integers(5, cfg.vocab_size, body - cut)
        token_ids[j, end:] = 0
        attn_mask[j, :end] = 1
        sent_ids[j, 1:end] = np.repeat(np.arange(n_sents), sent_tokens)
        abs_lens[j] = n_sents
    to = lambda a: torch.from_numpy(a).to(dev)
    return to(token_ids), to(attn_mask), to(sent_ids), to(abs_lens)


def answer(enc, request, solver: str):
    """One request: encode -> MultiVec -> OT rerank of document 0 against all.
    Returns (ranked ids, sims, sents, encode ms, score ms)."""
    from aspire_tpu_torch.core.types import MultiVec
    from aspire_tpu_torch.index.serve import ot_rerank
    token_ids, attn_mask, sent_ids, abs_lens = request
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, sents = enc(token_ids, attn_mask, sent_ids)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    docs = MultiVec(embed=sents, lens=abs_lens)
    query = MultiVec(embed=sents[:1], lens=abs_lens[:1])
    sims = ot_rerank(query, docs, blur=0.05, scaling=0.9, temp=5000.0,
                     solver=solver)
    ranked = torch.argsort(sims, descending=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return ranked.tolist(), sims, sents, (t1 - t0) * 1e3, (t2 - t1) * 1e3


def counters() -> dict:
    """Kernel name -> (wrapper, the attribute holding its launch count)."""
    from aspire_tpu_torch.ops.attention_kernel import fused_attention
    from aspire_tpu_torch.ops.dropout_kernel import fused_dropout
    from aspire_tpu_torch.ops.ffn_kernel import fused_ffn
    from aspire_tpu_torch.ops.pool_kernel import sentence_pool_fused
    from aspire_tpu_torch.ops.scan_kernel import (fused_l2max_scan,
                                                  fused_l2max_scan_int8_batched)
    from aspire_tpu_torch.ops.sinkhorn_kernel import sinkhorn_solve
    return {"sinkhorn": (sinkhorn_solve, "launches"),
            "attention": (fused_attention, "launches"),
            "ffn": (fused_ffn, "launches"),
            "attention_dropout": (fused_attention, "dropout_launches"),
            "attention_bwd": (fused_attention, "bwd_launches"),
            "dropout": (fused_dropout, "launches"),
            "pool": (sentence_pool_fused, "launches"),
            "scan_bf16": (fused_l2max_scan, "launches"),
            "scan_int8": (fused_l2max_scan_int8_batched, "launches")}


def read_counts() -> dict:
    return {k: getattr(w, attr) for k, (w, attr) in counters().items()}


def reset_counts() -> None:
    for w, attr in counters().values():
        setattr(w, attr, 0)


def serve_once(cfg, dtype, dev, n_requests: int, sents_atol: float,
               sims_atol: float, sims_rtol: float, label: str) -> dict:
    from aspire_tpu_torch.models.convert import state_dict_from_flax_params
    from aspire_tpu_torch.models.encoders import ConSentEncoder
    state = state_dict_from_flax_params(random_flax_tree(cfg, seed=0), cfg)
    enc = ConSentEncoder(cfg, max_sents=20, dtype=dtype, device=dev).eval()
    enc.load_state_dict(state)
    plain = ConSentEncoder(cfg, max_sents=20, dtype=dtype, device=dev,
                           attention_impl="naive", ffn_impl="naive",
                           pool_impl="naive").eval()
    plain.load_state_dict(state)
    requests = [make_request(cfg, 100 + i, dev) for i in range(n_requests)]
    layers = cfg.num_hidden_layers

    reset_counts()
    answers, per_request = [], []
    with torch.inference_mode():
        for request in requests:
            before = read_counts()
            answers.append(answer(enc, request, solver="kernel"))
            per_request.append({k: v - before[k]
                                for k, v in read_counts().items()})
    launches = read_counts()
    want = dict.fromkeys(read_counts(), 0)
    want.update(sinkhorn=1, attention=layers, ffn=layers, pool=1)
    for got in per_request:
        if got != want:
            raise AssertionError(f"{label}: launches per request {got}, "
                                 f"expected {want}")

    rows = []
    with torch.inference_mode():
        for i, (request, (ranked, sims, sents, enc_ms, score_ms)) in enumerate(
                zip(requests, answers)):
            if not (bool(torch.isfinite(sims).all())
                    and bool(torch.isfinite(sents).all())):
                raise AssertionError(f"{label}: non-finite output")
            if tuple(sents.shape) != (16, 20, cfg.hidden_size) \
                    or tuple(sims.shape) != (16,):
                raise AssertionError(f"{label}: wrong output shape")
            if ranked[0] != 0:
                raise AssertionError(f"{label}: document 0 ranks {ranked}")
            p_ranked, p_sims, p_sents, p_enc_ms, p_score_ms = answer(
                plain, request, solver="torch")
            # both paths round at the same places except the FFN, where the
            # naive path rounds the pre-activation to the compute dtype
            # before gelu; the tolerance covers that over every layer
            d_sents = check_close(f"{label} sents", sents, p_sents, sents_atol)
            d_sims = check_close(f"{label} sims", sims, p_sims, sims_atol,
                                 sims_rtol)
            if ranked != p_ranked:
                raise AssertionError(f"{label}: kernel path ranks {ranked}, "
                                     f"plain path {p_ranked}")
            rows.append({"request": i, "ms": enc_ms + score_ms,
                         "encode_ms": enc_ms, "score_ms": score_ms,
                         "plain_ms": p_enc_ms + p_score_ms,
                         "plain_encode_ms": p_enc_ms,
                         "plain_score_ms": p_score_ms, "ranked": ranked,
                         "sims_first_last": [float(sims[ranked[0]]),
                                             float(sims[ranked[-1]])],
                         "sents_max_abs_err": d_sents["max_abs_err"],
                         "sims_max_abs_err": d_sims["max_abs_err"]})
    emit("serve", label=label, dtype=str(dtype).split(".")[-1], layers=layers,
         hidden=cfg.hidden_size, heads=cfg.num_attention_heads,
         docs=16, tokens=256, max_sents=20, launches=launches,
         launches_per_request=want,
         tolerance={"sents_atol": sents_atol, "sims_atol": sims_atol,
                    "sims_rtol": sims_rtol},
         peak_memory_mb=torch.cuda.max_memory_allocated() / 2**20,
         requests=rows)
    return launches


def phase_serve(dev, layers: int) -> dict:
    from aspire_tpu_torch.models.bert import BertConfig
    # bf16 at full width.  bf16 keeps 8 bits: each layer adds a few 2^-8
    # relative roundings to O(1) states on both paths, independently.
    launches = serve_once(BertConfig(num_hidden_layers=layers), torch.bfloat16,
                          dev, 3, sents_atol=0.15, sims_atol=0.3,
                          sims_rtol=0.05, label="bert-base bf16")
    # f32 at two layers: only summation order and erf/exp routines differ
    serve_once(BertConfig(num_hidden_layers=2), torch.float32, dev, 1,
               sents_atol=1e-3, sims_atol=1e-2, sims_rtol=1e-3,
               label="2-layer f32")
    return launches


# ---------------------------------------------------------------------- train
def synth_superbatch(seed: int, n_micro: int, micro: int, seq: int, smax: int,
                     vocab: int, neg: bool = False) -> dict:
    """A training superbatch in the tokenizer's layout, from a numpy seed:
    [n_micro, micro, ...] token and sentence arrays (about seq / smax tokens a
    sentence, all smax sentences present) and pre-aligned index pairs."""
    rng = np.random.default_rng(seed)
    shape = (n_micro, micro, seq)
    sent_ids = np.broadcast_to(
        np.clip(np.arange(seq) * smax // seq, 0, smax - 1), shape).copy()

    def feats():
        return {"token_ids": rng.integers(5, vocab, shape),
                "attn_mask": np.ones(shape, np.int64), "sent_ids": sent_ids,
                "abs_lens": np.full((n_micro, micro), smax, np.int64)}

    out = {"query": feats(), "pos": feats()}
    out["pos"]["align"] = rng.integers(0, smax, (n_micro, micro, 2))
    if neg:
        out["neg"] = feats()
    return out


TRAIN_COUNTERS = ("attention_dropout", "attention_bwd", "dropout")


def flagship(cfg, dev, impl: str = "auto"):
    """The ts+otAspire training configuration on `cfg`, weights from seed 0."""
    from aspire_tpu_torch.core.config import ModelHParams
    from aspire_tpu_torch.models.convert import model_state_dict_from_flax_params
    from aspire_tpu_torch.models.doc_models import build_model
    hp = ModelHParams(model_name="sbalisentbienc",
                      score_aggregation="l2wasserstein", sent_sm_temp=5000.0,
                      sent_loss_prop=1.0, sentsup_loss_prop=1.0,
                      max_seq_len=512, max_sents=20, attention_impl=impl,
                      hidden_dropout_impl=impl, ffn_impl=impl)
    model = build_model(hp, cfg, dtype=torch.bfloat16, device=dev)
    model.load_state_dict(model_state_dict_from_flax_params(
        random_flax_tree(cfg, seed=0), hp.model_name, cfg))
    return hp, model


def _group_norms(model) -> dict:
    """Gradient norm of each parameter group: embeddings and every layer."""
    sums = {}
    for name, p in model.named_parameters():
        group = name.split(".")[2]           # encoder.bert.<group>...
        sums[group] = sums.get(group, 0.0) + float(p.grad.float().pow(2).sum())
    return {k: math.sqrt(v) for k, v in sums.items()}


def kernel_against_plain_step(cfg, dev, superbatch, seed: int) -> dict:
    """The main path's first step (its model, superbatch and generator seed):
    loss and gradients through the kernels and through the plain path (naive
    attention, dropout and FFN) fed the same Philox masks.  The plain path
    keeps [30, 12, 512, 512] scores, probabilities and masks of every layer
    for its backward."""
    from aspire_tpu_torch.train.trainer import tree_to_device as _to
    sb = _to(superbatch, dev)
    out, peak_mb = {}, {}
    for label, impl in (("kernel", "auto"), ("plain", "naive")):
        torch.cuda.reset_peak_memory_stats()
        _, model = flagship(cfg, dev, impl)
        loss, _ = model.train_loss_grouped(
            sb, torch.Generator().manual_seed(seed), True)
        loss.backward()
        out[label] = (float(loss.detach()), _group_norms(model))
        peak_mb[label] = torch.cuda.max_memory_allocated() / 2 ** 20
        del model, loss
        torch.cuda.empty_cache()
    (lk, nk), (lp, np_) = out["kernel"], out["plain"]
    # bf16 activations: both paths round at the same places but for the FFN
    # pre-activation and the backward's dprobs, independently over 12 layers
    if not math.isfinite(lk) or abs(lk - lp) > 1e-2 * abs(lp):
        raise AssertionError(f"train: first-step loss {lk} (kernels) against "
                             f"{lp} (plain path)")
    worst = max(abs(nk[g] - np_[g]) / np_[g] for g in np_)
    if not worst <= 0.05:
        raise AssertionError(f"train: gradient norms differ by {worst}: "
                             f"{nk} against {np_}")
    return {"superbatch": list(sb["query"]["token_ids"].shape),
            "loss_kernel": lk, "loss_plain": lp, "peak_memory_mb": peak_mb,
            "tolerance": {"loss_rel": 1e-2, "grad_norm_rel": 0.05},
            "grad_norm_rel_worst": worst, "grad_norms_kernel": nk,
            "grad_norms_plain": np_}


def _timed(batches, marks, counts):
    """Yields the superbatches, noting the host clock (after a synchronise)
    and the launch counts before each."""
    for sb in batches:
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        counts.append(read_counts())
        yield sb


def phase_train(dev, layers: int) -> dict:
    import tempfile
    from aspire_tpu_torch.core.config import RunConfig, TrainHParams
    from aspire_tpu_torch.models.bert import BertConfig
    from aspire_tpu_torch.train.trainer import Trainer
    from aspire_tpu_torch.train.trainer import tree_to_device as _to
    cfg = BertConfig(num_hidden_layers=layers)
    vocab = cfg.vocab_size
    steps = [synth_superbatch(300 + i, 10, 3, 512, 20, vocab) for i in range(5)]
    train_seed = 11
    against_plain = kernel_against_plain_step(cfg, dev, steps[0], train_seed)

    hp, model = flagship(cfg, dev)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tp = TrainHParams(batch_size=3, accumulated_batch_size=30,
                      update_rule="adam", learning_rate=2e-5,
                      lr_decay_method="warmuplin", num_warmup_steps=20,
                      train_size=3000, es_check_every=40)
    rc = RunConfig(model=hp, train=tp)
    dev_sb = synth_superbatch(400, 1, 3, 512, 20, vocab, neg=True)
    dev_batch = {k: {n: a[0] for n, a in v.items()} for k, v in dev_sb.items()}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    marks, counts = [], []
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(model, rc, tmp, fused_accum=True)
        state = trainer.init_state()
        state = trainer.train(state, _timed(steps[:4], marks, counts),
                              dev_batches_fn=lambda: [dev_batch],
                              seed=train_seed)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        counts.append(read_counts())
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        per_step = [{k: b_[k] - a_[k] for k in a_}
                    for a_, b_ in zip(counts[:-1], counts[1:])]
        # two encodes a step; a bf16 backward is three launches (delta, keys,
        # dq); 25 dropout sites at 12 layers, forward and backward
        want = {"attention_dropout": 2 * layers, "attention_bwd": 2 * 3 * layers,
                "dropout": 2 * 2 * (1 + 2 * layers)}
        for i, got in enumerate(per_step):
            if {k: got[k] for k in want} != want:
                raise AssertionError(f"train: step {i} launched {got}, "
                                     f"expected {want}")
        # the dev check came after step 4: three deterministic encodes
        dev_want = {"attention": 3 * layers, "ffn": 3 * layers}
        if {k: per_step[3][k] for k in dev_want} != dev_want \
                or any(got["attention"] or got["ffn"] for got in per_step[:3]):
            raise AssertionError(f"train: dev check launched {per_step}")
        if state.step != 4 or len(trainer.dev_score_history) != 1:
            raise AssertionError(f"train: step {state.step}, dev checks "
                                 f"{trainer.dev_score_history}")
        losses = trainer.loss_history
        if not losses or not all(math.isfinite(x) for x in losses) \
                or not math.isfinite(trainer.dev_score_history[0]):
            raise AssertionError(f"train: losses {losses}, dev score "
                                 f"{trainer.dev_score_history}")
        # the step held against the plain path above was this run's first
        first_loss = sum(losses[:10])
        if abs(first_loss - against_plain["loss_kernel"]) > 1e-4 * first_loss:
            raise AssertionError(
                f"train: the first step's loss {first_loss} is not the "
                f"{against_plain['loss_kernel']} held against the plain path")
        after = model.state_dict()
        changed = sum(not torch.equal(before[k], after[k]) for k in before)
        finite = all(bool(torch.isfinite(v).all()) for v in after.values())
        if changed != len(before) or not finite:
            raise AssertionError(f"train: {changed} of {len(before)} "
                                 f"parameters changed, finite={finite}")
        # checkpoint -> a fresh model gives the same dev loss
        _, restored = flagship(cfg, dev)
        restored.load_state_dict(trainer.load_checkpoint("cur_best"))
        dev_dev = _to(dev_batch, dev)
        with torch.no_grad():
            loss_a = float(model.train_loss(dev_dev, None, False))
            loss_b = float(restored.train_loss(dev_dev, None, False))
        if loss_a != loss_b or abs(-loss_a - trainer.dev_score_history[0]) \
                > 1e-6 * abs(loss_a):
            raise AssertionError(f"train: dev loss {loss_a}, restored "
                                 f"{loss_b}, check {trainer.dev_score_history}")
        # full state -> another trainer takes the fifth step
        trainer.save_full_state(state)
        resumed = Trainer(restored, rc, tmp, fused_accum=True)
        state2 = resumed.restore_full_state()
        lr = state2.scheduler.get_last_lr()[0]
        state2 = resumed.train(state2, [steps[4]], seed=12)
        if state2.step != 5 or resumed.best_score != trainer.best_score \
                or not all(math.isfinite(x) for x in resumed.loss_history):
            raise AssertionError(f"train: resumed to step {state2.step}, "
                                 f"losses {resumed.loss_history}")
    launches = read_counts()
    step_ms = [(b_ - a_) * 1e3 for a_, b_ in zip(marks[:-1], marks[1:])]

    # the sequential accumulation path, once, at two layers
    small = BertConfig(num_hidden_layers=2)
    _, model2 = flagship(small, dev)
    base = read_counts()
    with tempfile.TemporaryDirectory() as tmp:
        seq_trainer = Trainer(model2, rc, tmp, fused_accum=False)
        state3 = seq_trainer.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seq_losses = seq_trainer.train_step(
            state3, _to(steps[0], dev), torch.Generator().manual_seed(13))
        torch.cuda.synchronize()
        seq_ms = (time.perf_counter() - t0) * 1e3
    seq_counts = {k: read_counts()[k] - base[k] for k in TRAIN_COUNTERS}
    seq_want = {"attention_dropout": 10 * 2 * 2,
                "attention_bwd": 10 * 2 * 2 * 3, "dropout": 10 * 2 * 2 * 5}
    if seq_counts != seq_want or state3.step != 1 \
            or not bool(torch.isfinite(seq_losses).all()):
        raise AssertionError(f"train: sequential path launched {seq_counts}, "
                             f"expected {seq_want}; losses {seq_losses}")

    emit("train", model="sbalisentbienc l2wasserstein", dtype="bfloat16",
         layers=layers, hidden=cfg.hidden_size, heads=cfg.num_attention_heads,
         superbatch=[10, 3, 512], max_sents=20, optimizer="adam warmuplin",
         first_step_ms=step_ms[0], later_step_ms=step_ms[1:3],
         step_with_dev_check_and_checkpoints_ms=step_ms[3],
         peak_memory_mb=peak_mb, launches_per_step=want,
         launches_dev_check=dev_want, launches=launches,
         first_losses=losses[:10], first_step_loss=first_loss, dev_score=trainer.dev_score_history[0],
         lr_at_resume=lr, resumed_step=state2.step,
         kernel_path_against_plain_path=against_plain,
         sequential_path={"layers": 2, "step_ms": seq_ms,
                          "launches": seq_counts,
                          "losses": [float(x) for x in seq_losses]})
    return launches


# ---------------------------------------------------------------------- index
class SmokeTokenizer:
    """The four members text/tokenize.prepare_abstracts asks of a tokenizer,
    over words that are decimal token ids ("[SEP]" is 102)."""

    pad_token_id = 0

    def tokenize(self, text: str) -> list:
        return text.split()

    def convert_tokens_to_ids(self, tokens: list) -> list:
        return [102 if t == "[SEP]" else int(t) for t in tokens]

    def build_inputs_with_special_tokens(self, token_ids_0: list) -> list:
        return [101] + list(token_ids_0) + [102]


def synth_corpus(n_docs: int, vocab: int, seed: int) -> list:
    """Abstracts of clip(poisson(9), 3, 20) sentences of 8 to 12 words and a
    title of 6: about 110 tokens on average, the longest cut at the encode's
    254 content tokens."""
    rng = np.random.default_rng(seed)

    def words(n):
        return " ".join(map(str, rng.integers(min(1000, vocab // 2), vocab, n)))

    return [{"TITLE": words(6), "ABSTRACT": [
        words(int(rng.integers(8, 13)))
        for _ in range(int(np.clip(rng.poisson(9), 3, 20)))]}
        for _ in range(n_docs)]


def _pad_query(reps: np.ndarray, qmax: int, dev):
    q = np.zeros((qmax, reps.shape[1]), np.float32)
    n = min(len(reps), qmax)
    q[:n] = reps[:n]
    return torch.from_numpy(q).to(dev), n


def index_encode(cfg, dev, n_docs: int) -> dict:
    """Corpus -> encode (K2, K3, K4) -> bf16 and int8 dense indexes -> files ->
    a fused query (K8 or K7, K1) with a document's own sentences."""
    import tempfile
    from aspire_tpu_torch.index.build import encode_corpus
    from aspire_tpu_torch.index.dense import (
        DenseBucketIndex, build_dense_index, build_dense_index_prequantized,
        flatten_device_buckets)
    from aspire_tpu_torch.index.serve import make_fused_query
    from aspire_tpu_torch.models.convert import state_dict_from_flax_params
    from aspire_tpu_torch.models.encoders import ConSentEncoder
    enc = ConSentEncoder(cfg, max_sents=20, dtype=torch.bfloat16, device=dev)
    enc.load_state_dict(state_dict_from_flax_params(
        random_flax_tree(cfg, seed=0), cfg))
    corpus = synth_corpus(n_docs, cfg.vocab_size, seed=500)
    tok = SmokeTokenizer()
    kw = dict(batch_size=64, seq_len=256, max_sents=20)
    timings = []

    def timed(**extra):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = encode_corpus(enc, corpus, tok, **kw, **extra)
        torch.cuda.synchronize()
        timings.append(time.perf_counter() - t0)
        return out

    before = read_counts()
    reps, cls = timed()
    quant, _ = timed(quantize=True)
    batches = -(-n_docs // 64)
    got = {k: v - before[k] for k, v in read_counts().items()}
    layers = cfg.num_hidden_layers
    want = dict.fromkeys(got, 0)
    want.update(attention=2 * batches * layers, ffn=2 * batches * layers,
                pool=2 * batches)
    if got != want:
        raise AssertionError(f"index: the encode launched {got}, expected {want}")
    lens = [len(r) for r in reps]
    if len(reps) != n_docs or cls.shape != (n_docs, cfg.hidden_size) \
            or lens != [len(d["ABSTRACT"]) for d in corpus] \
            or not all(np.isfinite(r).all() for r in reps):
        raise AssertionError("index: wrong or non-finite encoded reps")
    pids = [f"p{i}" for i in range(n_docs)]
    buckets = (12, 24)
    t0 = time.perf_counter()
    indexes = {"bfloat16": build_dense_index(reps, pids, buckets=buckets),
               "int8": build_dense_index_prequantized(quant, pids, buckets=buckets)}
    build_s = time.perf_counter() - t0
    # quantised on the card == quantised on the host, bit for bit
    host = build_dense_index(reps, pids, buckets=buckets, dtype="int8")
    for bq, bh in zip(indexes["int8"].buckets, host.buckets):
        off = (int((bq["sents"] != bh["sents"]).sum()),
               int((bq["scales"] != bh["scales"]).sum()))
        if any(off):
            raise AssertionError(f"index: int8 made on the card differs from "
                                 f"the host's in {off[0]} elements and "
                                 f"{off[1]} scales of {bq['scales'].size}")
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, idx in indexes.items():
            idx.save(f"{tmp}/{name}")
            loaded = DenseBucketIndex.load(f"{tmp}/{name}")
            flat = flatten_device_buckets(loaded.device_arrays(dev))
            pos = loaded.device_pos_arrays(dev)
            fused = make_fused_query(len(loaded.buckets), k=10, max_sents=20,
                                     int8=loaded.is_int8, temp=5000.0)
            worst = 0.0
            for j in (0, 7, n_docs // 2, n_docs - 1):
                q, q_len = _pad_query(reps[j], 20, dev)
                v, d, s = fused(q, q_len, *flat, *pos)
                v, d, s = v.tolist(), d.tolist(), s.tolist()
                # the query is the f32 rep, the stored rows are rounded to
                # bf16 (int8) and so is the query inside the product: the
                # document's own distance is a rounding step of the storage,
                # held to 2 % of the runner-up's distance
                if d[0] != j or not abs(v[0]) <= 0.02 * abs(v[1]) \
                        or max(range(10), key=s.__getitem__) != 0 \
                        or not all(map(math.isfinite, v + s)):
                    raise AssertionError(
                        f"index: {name}: document {j} queried with its own "
                        f"sentences gives ids {d}, distances {v}, OT {s}")
                worst = max(worst, abs(v[0]) / abs(v[1]))
            rows[name] = {"own_distance_over_runner_up_worst": worst,
                          "last_query": {"ids": d, "first_stage": v, "ot": s}}
    emit("index_encode", docs=n_docs, layers=layers, dtype="bfloat16",
         batch=[64, 256], max_sents=20, buckets=list(buckets),
         sentences=int(sum(lens)),
         encode_s={"first_pass_f32_out": timings[0],
                   "second_pass_int8_out": timings[1]},
         docs_per_s={"first_pass_f32_out": n_docs / timings[0],
                     "second_pass_int8_out": n_docs / timings[1]},
         build_both_indexes_s=build_s, launches=got,
         int8_on_card_equals_host=True, own_distance_limit=0.02, queries=rows)
    return got


def _by_id(ids, *values) -> dict:
    return {i: vals for i, *vals in zip(ids, *values) if i >= 0}


def compare_answers(label, kernel, plain, ot_atol=1e-2, ot_rtol=5e-3) -> dict:
    """Kernel route against plain route, rows of (first stage, ids, OT): the
    same ids wherever neighbouring first-stage scores are further apart than
    the tolerance; first-stage scores within 2e-4 relative + 1e-3 (sums of 768
    products in another order, then a square root); OT scores of the ids both
    hold within 1e-2 + 5e-3 relative (the Sinkhorn case's limits on potentials,
    carried through exp(. / 0.05))."""
    worst = {"first_stage": 0.0, "ot": 0.0, "ids_differing": 0}
    for row, ((v_k, d_k, s_k), (v_p, d_p, s_p)) in enumerate(
            zip(zip(*kernel), zip(*plain))):
        v_k, d_k, s_k, v_p, d_p, s_p = (x.tolist() for x in
                                        (v_k, d_k, s_k, v_p, d_p, s_p))
        for a, b in zip(v_k, v_p):
            if not abs(a - b) <= 1e-3 + 2e-4 * abs(b):
                raise AssertionError(f"{label}: query {row}: first-stage "
                                     f"scores {v_k} against {v_p}")
            worst["first_stage"] = max(worst["first_stage"], abs(a - b))
        for pos, (a, b) in enumerate(zip(d_k, d_p)):
            if a == b:
                continue
            near = [abs(v_p[pos] - v_p[o]) for o in (pos - 1, pos + 1)
                    if 0 <= o < len(v_p)]
            if min(near) > 2 * (1e-3 + 2e-4 * abs(v_p[pos])):
                raise AssertionError(f"{label}: query {row}: ids {d_k} against "
                                     f"{d_p} where the scores are apart")
            worst["ids_differing"] += 1
        k_of, p_of = _by_id(d_k, s_k), _by_id(d_p, s_p)
        for i in set(k_of) & set(p_of):
            a, b = k_of[i][0], p_of[i][0]
            if not (math.isfinite(a) and abs(a - b) <= ot_atol + ot_rtol * abs(b)):
                raise AssertionError(f"{label}: query {row}: OT score of "
                                     f"document {i}: {a} against {b}")
            worst["ot"] = max(worst["ot"], abs(a - b))
    return worst


def _host_ms(fn, calls: int = 5) -> tuple:
    """First call and the following warm calls, host clock around a
    synchronise -> (times, the last call's result)."""
    out = []
    for _ in range(calls + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return {"first_ms": out[0], "warm_ms": statistics.median(out[1:]),
            "warm_ms_spread": [min(out[1:]), max(out[1:])]}, result


def _stage_ms(buckets, pos, q, q_lens, k, scan, solver, calls: int = 5) -> dict:
    """The fused query's three stages run apart, a synchronise after each."""
    from aspire_tpu_torch.core.types import MultiVec
    from aspire_tpu_torch.index.dense import score_buckets_batched
    from aspire_tpu_torch.index.serve import _gather_candidates, _tile_queries
    from aspire_tpu_torch.ops.distances import wasserstein_dist
    from aspire_tpu_torch.ops.sinkhorn import grouped_max_diameter
    marks = {"scan": [], "gather": [], "rerank": []}

    def lap(name, t0):
        torch.cuda.synchronize()
        marks[name].append((time.perf_counter() - t0) * 1e3)
        return time.perf_counter()

    for _ in range(calls):
        with torch.no_grad():
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, d = score_buckets_batched(buckets, q, q_lens, k, scan=scan)
            t = lap("scan", t)
            emb, cl, _ = _gather_candidates(buckets, *pos, d.reshape(-1), 20)
            t = lap("gather", t)
            qt = _tile_queries(q, q_lens, k)
            diam = grouped_max_diameter(qt.embed, emb, q.shape[0])
            wasserstein_dist(qt, MultiVec(emb, cl), temp=5000.0,
                             return_pair_sims=True, solver=solver,
                             diameter_value=diam)
            lap("rerank", t)
    return {f"{name}_ms": statistics.median(v) for name, v in marks.items()}


def build_large_index(dev, n_docs: int, buckets=(12, 24),
                      storages=("bfloat16", "int8")) -> dict:
    """A dense-bucket index in each of `storages` of n_docs documents of
    clip(poisson(9), 3, 20) sentences of 768-d reps, built by
    build_dense_index from numpy reps (seed 0) and put on the card."""
    from aspire_tpu_torch.index.dense import build_dense_index
    rng = np.random.default_rng(0)
    d = 768
    t0 = time.perf_counter()
    lens = np.clip(rng.poisson(9, n_docs), 3, 20)
    doc_reps = [rng.standard_normal((n, d), dtype=np.float32) * 2 for n in lens]
    host_s = {"reps": time.perf_counter() - t0}
    pids = list(range(n_docs))
    big = {"docs": n_docs, "dim": d, "bucket_sizes": list(buckets),
           "sentences": int(lens.sum()), "buckets": {}, "pos": {}, "stored": {}}
    for name in storages:
        t0 = time.perf_counter()
        idx = build_dense_index(doc_reps, pids, buckets=buckets, dtype=name)
        host_s[f"build_{name}"] = time.perf_counter() - t0
        big["buckets"][name] = idx.device_arrays(dev)
        big["pos"][name] = idx.device_pos_arrays(dev)
        big["stored"][name] = sum(a.nbytes for b in idx.buckets
                                  for a in b.values())
        del idx
    big["host_seconds"] = host_s
    return big


def scan_kernel_cases(big: dict, dev) -> dict:
    """K8 and K7 against their plain versions on the large index's buckets;
    the first case of each is the query path's shape (K7: the batch of 32)."""
    cases = {"scan_bf16": [case_scan_bf16(b, f"bucket {b['sents'].shape[1]}", dev)
                           for b in big["buckets"]["bfloat16"]],
             "scan_int8": [case_scan_int8(b, f"bucket {b['sents'].shape[1]}",
                                          bsz, dev)
                           for b in big["buckets"]["int8"] for bsz in (32, 1)]}
    cases["scan_int8"].append(case_scan_int8(
        big["buckets"]["int8"][0], "bucket 12", 5, dev, qmax=20))
    for name, rows in cases.items():
        emit("kernel_cases", kernel=name, cases=rows)
    return cases


def index_queries(big: dict, dev):
    """Fused queries (single bf16 at k=50, single int8 at k=64, a batch of 32
    int8 at k=64) and one pool ranking (8 queries x 512 ids, OT) through the
    kernels.  Returns a function that, called after the launch counts are
    read, runs the same through the plain route (scan='torch',
    solver='torch'), compares, times the stages apart and prints the line."""
    from aspire_tpu_torch.index.dense import flatten_device_buckets
    from aspire_tpu_torch.index.serve import (make_fused_query,
                                              make_fused_query_batched,
                                              make_pool_rank_batched)
    n_docs, d = big["docs"], big["dim"]
    nb = len(big["buckets"]["int8"])        # a bucket size no document has is left out
    qrng = np.random.default_rng(1)
    q_lens_np = qrng.integers(3, 17, 32)
    q_lens_np[0] = 10
    q_np = qrng.standard_normal((32, 16, d)).astype(np.float32) * 2
    q_np *= (np.arange(16)[None, :] < q_lens_np[:, None])[:, :, None]
    q_all = torch.from_numpy(q_np).to(dev)
    q_lens = torch.from_numpy(q_lens_np).to(dev)
    rows, later = [], []

    def per_call(before):
        return {name: (v - before[name]) // 6 for name, v in read_counts().items()
                if v != before[name]}

    def drive(label, storage, bsz, k, want):
        int8 = storage == "int8"
        buckets, pos = big["buckets"][storage], big["pos"][storage]
        flat = flatten_device_buckets(buckets)
        q, ql = q_all[:bsz], q_lens[:bsz]
        kw = dict(k=k, max_sents=20, int8=int8, temp=5000.0)
        if bsz == 1:
            fn_k = make_fused_query(nb, **kw)
            fn_p = make_fused_query(nb, scan="torch", solver="torch", **kw)
            call = lambda fn: tuple(x[None] for x in fn(q[0], ql[0], *flat, *pos))
        else:
            fn_k = make_fused_query_batched(nb, **kw)
            # the plain product keeps [c, n, s, q] f32: eight queries at a time
            fn_p = make_fused_query_batched(nb, scan="torch", solver="torch",
                                            q_chunk=8, **kw)
            call = lambda fn: fn(q, ql, *flat, *pos)
        before = read_counts()
        t_k, out_k = _host_ms(lambda: call(fn_k))
        got = per_call(before)
        if got != want:
            raise AssertionError(f"{label}: a call launched {got}, expected {want}")
        v, ids, sims = out_k
        if tuple(ids.shape) != (bsz, k) or int((ids < 0).sum()) \
                or not bool(torch.isfinite(sims).all()) \
                or not bool((v[:, :-1] >= v[:, 1:]).all()):
            raise AssertionError(f"{label}: malformed answer")
        row = {"query": label, "storage": storage, "batch": bsz, "k": k, **t_k,
               "ms_a_query": t_k["warm_ms"] / bsz, "launches_a_call": got,
               "first_ids": ids[0, :5].tolist(),
               "first_stage": v[0, :3].tolist(), "ot": sims[0, :3].tolist()}
        rows.append(row)

        def after():
            t_p, out_p = _host_ms(lambda: call(fn_p), calls=2)
            row.update(_stage_ms(buckets, pos, q, ql, k, "kernel", "kernel"))
            row["plain_route"] = {**t_p, **_stage_ms(buckets, pos, q, ql, k,
                                                     "torch", "torch", calls=2)}
            row["kernel_against_plain"] = compare_answers(label, out_k, out_p)
        later.append(after)

    drive("single bf16", "bfloat16", 1, 50, {"scan_bf16": nb, "sinkhorn": 1})
    drive("single int8", "int8", 1, 64, {"scan_int8": nb, "sinkhorn": 1})
    drive("batch of 32 int8", "int8", 32, 64, {"scan_int8": nb, "sinkhorn": 1})

    cand = torch.from_numpy(qrng.integers(0, n_docs, (8, 512)).astype(np.int32))
    cand[:, 500:] = -1
    cand = cand.to(dev)
    flat = flatten_device_buckets(big["buckets"]["bfloat16"])
    pool_args = (q_all[:8], q_lens[:8], cand, *flat, *big["pos"]["bfloat16"])
    pool_kw = dict(pool_size=512, max_sents=20, agg="ot", temp=5000.0)
    before = read_counts()
    t_k, s_k = _host_ms(lambda: make_pool_rank_batched(nb, **pool_kw)(*pool_args))
    got = per_call(before)
    live = cand >= 0
    if got != {"sinkhorn": 1} or not bool((s_k[~live] == -1e30).all()) \
            or not bool(torch.isfinite(s_k).all()):
        raise AssertionError(f"pool rank: a call launched {got}, or a pad slot "
                             f"scored")
    pool = {"queries": 8, "pool": 512, "agg": "ot", "storage": "bfloat16", **t_k,
            "launches_a_call": got}

    def finish():
        for after in later:
            after()
        t_p, s_p = _host_ms(lambda: make_pool_rank_batched(
            nb, solver="torch", **pool_kw)(*pool_args), calls=2)
        pool["plain_route"] = t_p
        pool["kernel_against_plain"] = check_close(
            "pool rank", s_k[live], s_p[live], atol=1e-2, rtol=5e-3)
        emit("index_query", docs=n_docs, dim=d, buckets=big["bucket_sizes"],
             sentences=big["sentences"],
             built_by="build_dense_index on the host, from numpy reps",
             host_seconds=big["host_seconds"], stored_bytes=big["stored"],
             device_memory_mb=torch.cuda.memory_allocated() / 2 ** 20,
             queries=rows, pool_rank=pool)

    return finish


def phase_index(dev, layers: int, encode_docs: int, index_docs: int) -> tuple:
    """The path from a corpus to an answered query.  The large index is built
    and the scan kernels are held against their plain versions first; then the
    counts are set to 0, the path is driven (encode -> indexes -> queries) and
    the counts are read; the plain route's runs come after that."""
    from aspire_tpu_torch.models.bert import BertConfig
    torch.cuda.empty_cache()
    big = build_large_index(dev, index_docs)
    cases = scan_kernel_cases(big, dev)
    reset_counts()
    index_encode(BertConfig(num_hidden_layers=layers), dev, encode_docs)
    finish = index_queries(big, dev)
    launches = read_counts()
    finish()
    return cases, launches


# ----------------------------------------------------------------------- main
KERNELS = [
    ("sinkhorn", "aspire_tpu_torch/csrc/sinkhorn.cu",
     "aspire_tpu/ops/pallas_sinkhorn.py:164"),
    ("attention", "aspire_tpu_torch/csrc/attention.cu",
     "aspire_tpu/ops/pallas_attention.py:210"),
    ("ffn", "aspire_tpu_torch/csrc/ffn.cu",
     "aspire_tpu/ops/pallas_ffn.py:102"),
    ("attention_dropout", "aspire_tpu_torch/csrc/attention.cu",
     "aspire_tpu/ops/pallas_attention.py:210"),
    ("attention_bwd", "aspire_tpu_torch/csrc/attention_bwd.cu",
     "aspire_tpu/ops/pallas_attention.py:229"),
    ("dropout", "aspire_tpu_torch/csrc/dropout.cu",
     "aspire_tpu/ops/pallas_dropout.py:110"),
    ("pool", "aspire_tpu_torch/csrc/pool.cu",
     "aspire_tpu/ops/pallas_pool.py:81"),
    ("scan_bf16", "aspire_tpu_torch/csrc/scan.cu",
     "aspire_tpu/ops/pallas_scan.py:77"),
    ("scan_int8", "aspire_tpu_torch/csrc/scan.cu",
     "aspire_tpu/ops/pallas_scan.py:180"),
]


# the kernels each path must launch (its counts are set to 0 just before it
# is driven and read just after)
PATH_KERNELS = {
    "serve": ("sinkhorn", "attention", "ffn", "pool"),
    "train": ("attention", "ffn", "attention_dropout", "attention_bwd",
              "dropout", "pool"),
    "index": ("sinkhorn", "attention", "ffn", "pool", "scan_bf16", "scan_int8"),
}


def run(args) -> dict:
    dev = torch.device("cuda", 0)
    # references and scoring run in full float32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device()
    phase_build()
    cases, launches = {}, {}
    if args.phases in ("all", "kernels"):
        cases = phase_kernels(dev)
    if args.phases in ("all", "index"):
        cases["pool"] = phase_pool_kernel(dev)
    if args.phases == "all":
        launches["serve"] = phase_serve(dev, args.layers)
        launches["train"] = phase_train(dev, args.train_layers)
    if args.phases in ("all", "index"):
        scan_cases, launches["index"] = phase_index(
            dev, args.layers, args.encode_docs, args.index_docs)
        cases.update(scan_cases)
    for path, counts in launches.items():
        idle = [name for name in PATH_KERNELS[path] if counts[name] < 1]
        if idle:
            raise AssertionError(f"the {path} path launched no {idle}")
    rows = []
    for name, source, replaces in KERNELS:
        if name not in cases:
            continue                        # a run of some phases alone
        first = cases[name][0]              # the main path's shape
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(counts[name] for counts in launches.values()),
            **{f"launches_{path}": counts[name]
               for path, counts in launches.items()},
            "shape": first["case"], "max_abs_err": first["max_abs_err"],
            "max_rel_err": first["max_rel_err"],
            "tolerance": {"atol": first["atol"], "rtol": first["rtol"]},
            **{key: first[key] for key in ("norm_rel_err", "norm_rel_limit")
               if key in first},
            "ms": first["kernel_ms"]["median"],
            "kernel_ms": first["kernel_ms"]["median"],
            "kernel_ms_spread": [first["kernel_ms"]["min"],
                                 first["kernel_ms"]["max"]],
            "plain_ms": first["plain_ms"]["median"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": (None if first["library_ms"] is None
                           else first["library_ms"]["median"])})
    return {"kernels": rows}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--layers", type=int, default=12,
                        help="depth of the bf16 serving model (widths stay "
                             "BERT-base)")
    parser.add_argument("--train-layers", type=int, default=12,
                        help="depth of the bf16 training model (widths stay "
                             "BERT-base)")
    parser.add_argument("--encode-docs", type=int, default=512,
                        help="abstracts the index phase encodes")
    parser.add_argument("--index-docs", type=int, default=125_000,
                        help="documents of the index the queries run on")
    parser.add_argument("--phases", default="all",
                        choices=("all", "index", "kernels"),
                        help="'index' drives the index path alone (the pool "
                             "and scan kernels' cases, encode, queries); "
                             "'kernels' holds K1-K3 and K5a-K6 against their "
                             "plain versions and drives no path")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return 1
    import aspire_tpu_torch  # noqa: F401  (fails here when run outside the repo)
    try:
        kernels_line = run(args)
    except Exception as exc:
        print(json.dumps({"ok": False, "error": f"{type(exc).__name__}: {exc}"}),
              flush=True)
        raise
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(kernels_line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
