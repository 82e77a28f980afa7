#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, needs one card and nvcc

Phases, one JSON object a line:

  device   the card (name and power limit as nvidia-smi prints them) and the
           torch / CUDA / nvcc / triton versions;
  build    nvcc builds aspire_tpu_torch/csrc/*.cu into one shared library;
  kernels  each CUDA kernel against its plain PyTorch version on the card, at
           the shapes the serving path gives it and a few more, with times;
  serve    full-width BERT-base ConSent encode (bf16, 12 layers, weights from
           a numpy seed) of 16 abstracts x 256 tokens, then an OT rerank of
           document 0 against all 16; three requests; the same requests
           through the plain path (naive attention and FFN, PyTorch solver);
           then once more in f32 at two layers.

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


def cuda_ms(fn) -> dict:
    """Median / min / max milliseconds of fn() by CUDA events: REPEATS
    readings of INNER back-to-back calls each, after WARMUP calls."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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


def phase_kernels(dev) -> dict:
    """Runs every case; the first case of each kernel is the serving path's
    shape and feeds the contract line."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = {
        "sinkhorn": [case_sinkhorn(16, "global", dev),
                     case_sinkhorn(50, "global", dev),
                     case_sinkhorn(1024, "global", dev),
                     case_sinkhorn(1024, "pair", dev)],
        "attention": [case_attention(16, 12, 256, 64, bf16, dev),
                      case_attention(4, 12, 512, 64, bf16, dev),
                      case_attention(16, 12, 256, 64, f32, dev),
                      case_attention(4, 12, 512, 64, f32, dev),
                      case_attention(2, 12, 200, 64, bf16, dev)],
        "ffn": [case_ffn(4096, bf16, dev), case_ffn(4059, bf16, dev),
                case_ffn(1024, bf16, dev),
                case_ffn(4096, f32, dev), case_ffn(1001, f32, dev)],
    }
    for name, rows in cases.items():
        emit("kernel_cases", kernel=name, cases=rows)
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
    from aspire_tpu_torch.ops.attention_kernel import fused_attention
    from aspire_tpu_torch.ops.ffn_kernel import fused_ffn
    from aspire_tpu_torch.ops.sinkhorn_kernel import sinkhorn_solve
    return {"sinkhorn": sinkhorn_solve, "attention": fused_attention,
            "ffn": fused_ffn}


def serve_once(cfg, dtype, dev, n_requests: int, sents_atol: float,
               sims_atol: float, sims_rtol: float, label: str) -> dict:
    from aspire_tpu_torch.models.convert import state_dict_from_flax_params
    from aspire_tpu_torch.models.encoders import ConSentEncoder
    state = state_dict_from_flax_params(random_flax_tree(cfg, seed=0), cfg)
    enc = ConSentEncoder(cfg, max_sents=20, dtype=dtype, device=dev).eval()
    enc.load_state_dict(state)
    plain = ConSentEncoder(cfg, max_sents=20, dtype=dtype, device=dev,
                           attention_impl="naive", ffn_impl="naive").eval()
    plain.load_state_dict(state)
    requests = [make_request(cfg, 100 + i, dev) for i in range(n_requests)]
    layers = cfg.num_hidden_layers
    wrappers = counters()

    for w in wrappers.values():
        w.launches = 0
    answers, per_request = [], []
    with torch.inference_mode():
        for request in requests:
            before = {k: w.launches for k, w in wrappers.items()}
            answers.append(answer(enc, request, solver="kernel"))
            per_request.append({k: w.launches - before[k]
                                for k, w in wrappers.items()})
    launches = {k: w.launches for k, w in wrappers.items()}
    want = {"sinkhorn": 1, "attention": layers, "ffn": layers}
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


# ----------------------------------------------------------------------- main
KERNELS = [
    ("sinkhorn", "aspire_tpu_torch/csrc/sinkhorn.cu",
     "aspire_tpu/ops/pallas_sinkhorn.py:164"),
    ("attention", "aspire_tpu_torch/csrc/attention.cu",
     "aspire_tpu/ops/pallas_attention.py:210"),
    ("ffn", "aspire_tpu_torch/csrc/ffn.cu",
     "aspire_tpu/ops/pallas_ffn.py:102"),
]


def run(args) -> dict:
    dev = torch.device("cuda", 0)
    # references and scoring run in full float32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device()
    phase_build()
    cases = phase_kernels(dev)
    launches = phase_serve(dev, args.layers)
    rows = []
    for name, source, replaces in KERNELS:
        first = cases[name][0]              # the serving path's shape
        if launches[name] < 1:
            raise AssertionError(f"the serving path never launched {name}")
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "shape": first["case"], "max_abs_err": first["max_abs_err"],
            "max_rel_err": first["max_rel_err"],
            "tolerance": {"atol": first["atol"], "rtol": first["rtol"]},
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
