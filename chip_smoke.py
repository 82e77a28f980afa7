#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's serving, training, index, several-rank, evaluation, data-pipeline, baseline-family and check paths on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, needs one card and nvcc
    python3 chip_smoke.py --layers 2 --train-layers 2    # quicker, same widths
    python3 chip_smoke.py --phases index --index-docs 20000   # the index path alone
    python3 chip_smoke.py --phases kernels   # every kernel against its plain version, alone
    python3 chip_smoke.py --phases eval      # the CLI's evaluate and train alone
    python3 chip_smoke.py --phases chain     # the data pipeline's two-model chain alone
    python3 chip_smoke.py --phases families  # the examples and the RoBERTa / MPNet baselines alone
    python3 chip_smoke.py --phases checks    # the convergence and int8 checks alone
    python3 chip_smoke.py --phases mesh      # the several-rank paths alone
    python3 chip_smoke.py --phases pools     # the headline's and the deep pools' twins alone
    python3 chip_smoke.py --phases ranges    # the kernels' input ranges and their paths alone

Phases run in the order device, build, kernels, serve, train, index, mesh,
eval, chain, families, checks, pools, ranges; each prints its seconds (a
`phase_seconds` line).

Phases, one JSON object a line:

  device   the card (name and power limit as nvidia-smi prints them) and the
           torch / CUDA / nvcc / triton versions;
  build    nvcc builds aspire_tpu_torch/csrc/*.cu into one shared library;
  kernels  each CUDA kernel against its plain PyTorch version on the card, at
           the shapes the serving and training paths give it and a few more
           (Sinkhorn pairs past 32 atoms, each Sinkhorn case in both modes --
           after the final step, and the loop's own potentials as the
           training loss takes them -- heads of 32 and 8 columns padded to
           64, FFN widths other than 768 padded to multiples of 64), with
           times; the dropout kernels with the bits given and with the bits
           made in the kernel (masks equal to ops/philox.py's, also with a
           data rank's row and plane offsets); then
           BertConfig.tiny() encoding on the card under 'auto' against 'naive';
  serve    full-width BERT-base ConSent encode (bf16, 12 layers, weights from
           a numpy seed) of 16 abstracts x 256 tokens, then an OT rerank of
           document 0 against all 16; three requests; the same requests
           through the plain path (naive attention and FFN, PyTorch solver);
           then once more in f32 at two layers;
  index    the path from a corpus to an answered query.  A bf16 and an int8
           dense-bucket index of 125,000 documents (clip(poisson(9), 3, 20)
           sentences of 768-d reps, buckets (12, 24), numpy seed 0) are built
           by build_dense_index on the host and put on the card; the scan
           kernels are held against their plain versions on its buckets (and
           K8 on bucket 12 in f32).
           Then, with the launch counts at 0: 512 synthetic abstracts through
           encode_corpus (12-layer bf16 ConSentEncoder, batches of 64 x 256
           tokens, 20 sentences; once with f32 reps out, once quantised to
           int8 on the card), a bf16 and a prequantised int8 index of them,
           saved, loaded, and queried with a document's own sentences; on the
           large index a single fused query on bf16 (k=50) and on int8 (k=64),
           a batch of 32 on int8 (k=64) and a pool ranking of 8 queries x 512
           ids.  After the counts are read, the same through the plain route
           (scan='torch', solver='torch'), compared, and the stages timed
           by the entry's own spans (scan, gather, rerank);
           then a float32 index of 20,000 documents queried through the scan
           kernel's f32 instantiation and through the plain product;
  mesh     several ranks, each a process, all on the one card (a `mesh` line
           says so): (a) 4 serving ranks over gloo map the index phase's
           bf16 and int8 indexes (saved by it; built here when the phase
           runs alone) and each puts its quarter of every bucket on cuda:0;
           with each rank's counts at 0, a single bf16 fused query (k=50:
           K8 on the rank's slices, the top-k merged by an all_gather, K1 on
           the candidates the rank owns, each pair with its query's pool
           diameter from a MIN and a MAX all_reduce, the scores merged by a
           SUM all_reduce), a batch of 32 on int8 (k=64: K7) and a pool
           ranking of 8 x 512 ids (K1); held to the one-process answers on
           the same index (ids where the scores are apart, first stage 1e-3
           + 2e-4 relative, OT 1e-2 + 5e-3 relative); ms a query on rank 0's
           host clock, scan, merge, gather, rerank and reduce as the
           entry's spans time them on each rank, the bytes each
           collective carries; (b) 3 data ranks over gloo train the train
           phase's flagship (BERT-base width, [10, 3, 512], bf16 over f32
           parameters, Adam), each rank 10 of the window's 30 rows: the first
           step's loss and gradient norms against one process (1e-2, 5%),
           three steps through K5a, K5b, K6, K4, K1's loop-only mode and a
           dev check (K2, K3), the ranks' parameters equal bit for bit after
           them, step ms and peak memory a rank; (c) one step in this process
           as a world of one over NCCL, held to the same first step;
  train    full-width BERT-base ts+otAspire model (sbalisentbienc, bf16 over
           f32 parameters, weights from a numpy seed): the first step's loss
           and gradient norms through the kernels against the plain path fed
           the same Philox masks and built on the plain Sinkhorn loop (the
           same model, superbatch and seed as the step that follows; the
           kernel path runs the loop as one K1 launch a distance, two a
           step); then Trainer.train for four
           optimizer steps on superbatches [10, 3, 512] with one wide encode
           a side, a dev-loss check on a batch with explicit negatives, the
           checkpoint restored into a fresh model, the full state saved,
           restored and one more step taken; then one step of the sequential
           accumulation path at two layers.  Then, with the launch counts
           at 0, the f32 training step (`train --no-bf16-compute`: f32
           activations through the f32 K5a, K5b and K6): its first step
           against the plain path in f32, three optimizer steps with each
           step's launches checked, an `f32 train` line (step ms, peak
           memory, the card) and a train_f32 line;
  eval     the user's entry points, aspire_tpu_torch.cli.main in this
           process, at BERT-base width: a Hugging Face BERT directory written
           from a numpy seed (30,522-entry vocab.txt, tokenizer_config.json,
           random weights in pytorch_model.bin) and a dataset in CSFCube's
           layout (the real fold query ids, 16-17 a facet, pools of 120 from
           2,000 abstracts of 3-20 sentences; five near copies of each query
           are its relevant candidates).  First the kernels at the
           evaluation's shapes (K2 and K3 in f32 at 8 x 512 tokens, K4, K1 at
           256 pairs of 24 x 24).  Then `evaluate --ot-solver pallas` (f32
           encode through K2, K3, K4; one K1 launch a query) over the three
           facets and 'all', held to MAP >= 0.9; the same with `--ot-solver
           xla` (the plain loop), score by score; the plain encoder route on
           64 abstracts against the kernel route; `train` from a jsonl of
           triples (sbalisentbienc, micro 3, accumulation 6, 12 examples: two
           steps, seq 512, bf16, --init-hf-dir); `evaluate --model otaspire
           --run-dir` on that run;
  chain    the two-model supervision chain (scripts/torch_e2e_chain.py's
           pilot corpus: 4 topics, 8 batch files, 208 papers; BERT-base
           encoders, 64 tokens a sentence, 128 a document; each training cut
           to 4 optimizer steps), every stage through
           aspire_tpu_torch.cli.main with the counts set to 0 before it and
           read after it: `preprocess gorc` (a spawn pool of 4; once more as
           a subprocess, `python -m aspire_tpu_torch`, whose files must be
           the same), `train` cosentbert, `preprocess regen-examples` with
           that run as the aligner (f32 on the card: 12 K2 and 36 K3 launches
           a call), `train` sbalisentbienc on the aligned triples,
           `build-index`, `rank --rerank ot`; the aligner's kernel route
           against its plain route on every sentence of the examples (1e-4;
           alignments equal where the argmax leads by more than 1e-4); MAP
           and NDCG%20 beside a random ranking's MAP (reported, not held);
           then K2 and K3 in f32 at the aligner's shapes;
  families the examples (examples/*_torch.py), each as a subprocess on the
           card, the three side by side, against the same script's
           --device cpu run (scores within 1e-4, the OT similarity and plan
           within 1e-3), then once more in this process with the counts set
           to 0 before and read after; then `evaluate` with sbrobertanli and
           sbmpnet1B on one facet of the eval phase's dataset, each from a
           directory written from a numpy seed at its published widths
           (RoBERTa-base with a 50,265-entry byte-level BPE, MPNet-base with
           a 30,527-entry WordPiece and 32 relative buckets): abstracts a
           second, launches (12 K2 f32 + 36 K3 f32 a RoBERTa batch, 36 K3
           f32 a MPNet batch), the kernel encode against the plain route on
           64 abstracts (1e-4); then K2 f32 and K3 f32 at the families'
           sentence shapes.  The examples include the demo notebook's twin
           (examples/demo-contextualsentence-multim_torch.ipynb), its code
           cells run in this process on the card and with DEVICE = "cpu";
  checks   benchmarks/torch_convergence_check.py at full size (160 steps,
           its descent asserted, each step's launches counted), then
           scripts/torch_int8_validation.py --random-bert on 4,000 + 50
           abstracts of the chain's synthesiser (reported, not gated);
  pools    the twins of bench.py's headline (benchmarks/torch_bench.py:
           1,024 pairs of up to 20 x 20 sentences, one K1 launch) and of the
           deep-pool bench (benchmarks/torch_pool_bench.py: an OT pool
           ranking of 8 queries x 2,048 candidates from 100,000 documents of
           a bf16 bucket on the card, two K1 launches) at full size, with the
           counts set to 0 before them, each against solver='torch'; 16
           pairs of the pools rescored alone; K1 at both shapes against its
           plain version;
  ranges   the kernels' input ranges past the 64-wide heads, one block's
           Sinkhorn pair and 128 query sentences (their kernel cases run in
           the kernels phase, or first when the phase runs alone), on their
           paths, with the counts set to 0 before: BERT-base width as 6
           heads of 128 -- a request encoded in bf16 and f32 through the wide
           K2 against 'naive', the flagship's first step against the plain
           path in bf16 and f32 and four optimizer steps in bf16 (the wide K5a
           and K5b, each step's launches counted, the warm steps' ms read
           apart), and `python -m
           aspire_tpu_torch train --init-hf-dir` on a local BERT directory
           with such heads, two steps in a subprocess; then an index of 2,000
           documents of 240-1,200 sentences (768-d reps drawn on the card
           from a seed, bf16 and int8, buckets 400 / 800 / 1,200), a fused query of 300
           sentences on bf16 (K8, its three groups of 128 rows in one
           launch a bucket on csrc/scan_int8.cu's bf16 kernel, K1's large
           pairs) and a batch of 8 on int8 (K7 with the groups as extra
           queries), each against the plain scan and solver='torch', and
           `rank --rerank ot --max-sents 1200` (the pool protocol, one facet)
           with that run against `--ot-solver xla`.

Any failed check raises: the run then prints {"ok": false, ...} and exits
with code 1.  Without CUDA it exits with code 1 before printing any result.
The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
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
PEAK_TF32 = 495e12            # tensor cores in TF32, FLOP/s
# An f32 product can run on the FP32 lanes or, split into TF32 parts (three
# products: lo.hi + hi.lo + hi.hi), on the tensor cores at f32 accuracy: its
# operations bound is the lesser of ops / PEAK_FP32 and 3 ops / PEAK_TF32.
PEAK_F32_PRODUCT = max(PEAK_FP32, PEAK_TF32 / 3)
# exp/log go through the special-function units: 16 an SM against 128 FP32
# lanes, each of which counts 2 FLOP in PEAK_FP32 -> PEAK_FP32 / 2 / 8 calls/s.
PEAK_SFU = PEAK_FP32 / 2 / 8

REPO = pathlib.Path(__file__).resolve().parent

REPEATS, WARMUP, INNER = 20, 3, 5


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


HEAD_START_CYCLES = 2_000_000      # about a millisecond of device spinning
CARD = None                        # the card's name and power limit (device line)


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


def product_peak(dtype) -> float:
    """Peak rate of a product's operations in the given compute dtype."""
    return PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32_PRODUCT


def f64_errors(**routes) -> dict:
    """Largest absolute error of each route's output against the f64 one:
    f64_errors(f64=reference, kernel=..., plain=...)."""
    ref = routes.pop("f64")
    return {name: float((out.double() - ref).abs().max())
            for name, out in routes.items()}


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
    global CARD
    CARD = smi
    info = {"card": smi, "python": sys.version.split()[0],
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": " | ".join(nvcc), "triton": triton_version,
            "capability": list(torch.cuda.get_device_capability(0))}
    emit("device", **info)


# ---------------------------------------------------------------------- build
def kernel_entry(mangled: str) -> str:
    """'name<args>' of a kernel's mangled name in a namespace, as in
    '_ZN<len>ns<len>name' + 'I' template arguments 'E' + parameters."""
    if not mangled.startswith("_ZN"):
        return mangled
    i, name = 3, mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    if not mangled.startswith("I", i):
        return name
    args, i = [], i + 1
    builtin = {"f": "float", "a": "int8", "h": "uint8", "i": "int", "b": "bool"}
    while i < len(mangled) and mangled[i] != "E":
        if mangled.startswith("Li", i):
            j = mangled.index("E", i)
            args.append(mangled[i + 2:j])
            i = j + 1
        elif mangled.startswith("Lb", i):
            j = mangled.index("E", i)
            args.append("true" if mangled[i + 2:j] == "1" else "false")
            i = j + 1
        elif mangled[i].isdigit():
            j = i
            while mangled[j].isdigit():
                j += 1
            args.append(mangled[j:j + int(mangled[i:j])])
            i = j + int(mangled[i:j])
        else:
            args.append(builtin.get(mangled[i], mangled[i]))
            i += 1
    return f"{name}<{','.join(args)}>"


def phase_build() -> None:
    from aspire_tpu_torch.ops import _build
    _build.load()
    kernels = []
    for m in re.finditer(
            r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, "
            r"(\d+) bytes spill loads.*?Used (\d+) registers", _build.build_log,
            re.S):
        kernels.append({"entry": kernel_entry(m.group(1)), "registers": int(m.group(4)),
                        "spill_stores": int(m.group(2)),
                        "spill_loads": int(m.group(3))})
    emit("build", seconds=_build.build_seconds,
         sources=[str(p.relative_to(_build.CSRC.parent.parent))
                  for p in _build.sources()],
         flags=" ".join(_build.NVCC_FLAGS), ptxas=kernels)


# -------------------------------------------------------------------- kernels
def sinkhorn_inputs(bsz: int, seed: int, diameter: str, dev, n: int = 20, m: int = 20):
    """The scoring shape of the pair bench: 20 x 20 sentences, 768-d, lens
    4..20, temp 5000 (or n x m sentences, lens from a fifth of the side up)
    -> (q, c, cost, log_a, log_b, diam, a, b).  diameter 'grouped': each
    group of 3 pairs anneals from its own diameter, as the training step's
    micro batches of 3 do (`grouped_max_diameter`)."""
    from aspire_tpu_torch.core.types import MultiVec
    from aspire_tpu_torch.ops.cdist import pairwise_l2
    from aspire_tpu_torch.ops.distances import ot_marginals
    from aspire_tpu_torch.ops.sinkhorn import (grouped_max_diameter, log_weights,
                                               resolve_diameter)
    rng = np.random.default_rng(seed)
    d = 768

    def side(smax):
        lens = rng.integers(max(1, smax // 5), smax + 1, bsz)
        emb = rng.standard_normal((bsz, smax, d)).astype(np.float32) * 2.0
        emb *= (np.arange(smax)[None, :] < lens[:, None])[:, :, None]
        return MultiVec(torch.from_numpy(emb).to(dev),
                        torch.from_numpy(lens).to(dev))

    q, c = side(n), side(m)
    cost = pairwise_l2(q.embed, c.embed)
    a, b, _ = ot_marginals(q, c, temp=5000.0, cost=cost)
    if diameter == "grouped":
        diam = grouped_max_diameter(q.embed, c.embed, bsz // 3)
    else:
        diam = resolve_diameter(q.embed, c.embed, a, b, diameter, None).contiguous()
    return q, c, cost, log_weights(a), log_weights(b), diam, a, b


def sinkhorn_bound(cost, diam, blur=0.05, scaling=0.9, max_iters=128,
                   extrapolate=True) -> dict:
    bsz, n, m = cost.shape
    ratio = torch.log(blur / diam.clamp_min(1e-30)) / math.log(scaling)
    iters = (torch.ceil(ratio.clamp_min(0.0)) + 2.0).clamp_max(max_iters)
    # + the first round and, when extrapolating, the final step
    rounds = float((iters + 1.0 + extrapolate).sum())
    calls = rounds * (2 * n * m + n + m)        # exp per cell twice, log per atom
    moved = 4.0 * (bsz * n * m + 2 * bsz * (n + m) + bsz)
    out = bound(moved, calls, PEAK_SFU)
    out["mean_iters"] = float(iters.mean())
    return out


def case_sinkhorn(bsz: int, diameter: str, dev, n: int = 20, m: int = 20,
                  reference_f64: float | None = None) -> dict:
    """K1 in both modes against its plain version: after the final step (the
    serving and query paths) and the loop's own potentials (extrapolate=False,
    the training loss); for the first, also the scores and plans of
    `wasserstein_dist` through the kernel against the PyTorch solver (both
    against the PyTorch solver in f64, `f64_witness`, held on every route), and
    for the second the training distance through solver 'auto' against
    'torch'.  reference_f64: for a draw whose f32 solver lands nearer f64
    than the JAX package's own f32 solvers (one atom against many), the
    scores are held to the reference's distance instead (`reference_witness`)."""
    from aspire_tpu_torch.core.types import MultiVec
    from aspire_tpu_torch.ops import sinkhorn_kernel as sk
    from aspire_tpu_torch.ops.distances import wasserstein_dist
    q, c, cost, la, lb, diam, a, b = sinkhorn_inputs(bsz, 7 + bsz + n + m, diameter,
                                                     dev, n, m)
    # potentials mean something only at atoms with mass; f32 on both sides,
    # other summation order and exp/log routines over ~70 compounding rounds
    tol = dict(atol=1e-3, rtol=1e-3)
    modes = {}
    for extrapolate in (True, False):
        f, g = sk.sinkhorn_solve(cost, la, lb, diam, extrapolate=extrapolate)
        torch.cuda.synchronize()
        fp, gp = sk.sinkhorn_solve_plain(cost, la, lb, diam, extrapolate=extrapolate)
        res = check_close("sinkhorn f", f, fp, mask=a > 0, **tol)
        res_g = check_close("sinkhorn g", g, gp, mask=b > 0, **tol)
        modes[extrapolate] = {k: max(res[k], res_g[k]) for k in res}
    res = modes[True]
    dkw = (dict(diameter_value=diam) if diameter == "grouped"
           else dict(diameter=diameter))
    kw = dict(temp=5000.0, return_pair_sims=True, **dkw)
    sims_k, (_, _, _, plan_k, _) = wasserstein_dist(q, c, solver="kernel", **kw)
    sims_t, (_, _, _, plan_t, _) = wasserstein_dist(q, c, solver="torch", **kw)
    sims = check_close("sinkhorn sims", sims_k, sims_t, atol=2e-3, rtol=2e-3)
    plan = check_close("sinkhorn plan", plan_k, plan_t, atol=2e-3, rtol=0.0)
    launched = lambda: (sk.sinkhorn_solve.launches + sk.sinkhorn_solve.wide_launches
                        + sk.sinkhorn_solve.large_launches)
    before = launched()
    dist_a = wasserstein_dist(q, c, temp=5000.0, **dkw)
    if launched() != before + 1:
        raise AssertionError("wasserstein_dist(solver='auto') launched "
                             f"{launched() - before} K1 kernels")
    dist_t = wasserstein_dist(q, c, temp=5000.0, solver="torch", **dkw)
    dist = check_close("sinkhorn auto distance", dist_a, dist_t, atol=2e-3, rtol=2e-3)
    res.update(sims_max_abs_err=sims["max_abs_err"],
               plan_max_abs_err=plan["max_abs_err"],
               auto_distance_max_abs_err=dist["max_abs_err"])
    kw64 = {**kw, "diameter_value": diam.double()} if diameter == "grouped" else kw
    sims_64, _ = wasserstein_dist(MultiVec(q.embed.double(), q.lens),
                                  MultiVec(c.embed.double(), c.lens), solver="torch", **kw64)
    route = sk.sinkhorn_route(n, m, bsz)
    label = f"sinkhorn sims {route} B={bsz} {n}x{m}"
    res["sims_f64"] = (f64_witness(label, sims_k, sims_t, sims_64)
                       if reference_f64 is None else
                       reference_witness(label, sims_k, sims_t, sims_64, reference_f64))
    t_k = cuda_ms(lambda: sk.sinkhorn_solve(cost, la, lb, diam))
    t_l = cuda_ms(lambda: sk.sinkhorn_solve(cost, la, lb, diam, extrapolate=False))
    t_p = cuda_ms(lambda: sk.sinkhorn_solve_plain(cost, la, lb, diam))
    if route == "wide":
        # the layout the wide-pair kernel's block runs
        team, threads = sk.wide_plan(n, m)
        lay = sk.wide_layout(n, m, team)
        res["layout"] = {"team": team, "threads": threads,
                         "o_threads": sk.wide_threads(n, m, team)[0],
                         "pitch": lay.pitch, "table_rounds": lay.table,
                         "shared_bytes": 4 * lay.floats}
    if route == "large":
        # the cluster the large-pair kernel runs a pair on, and how many of
        # them the card holds at once
        c, res_rows = sk.cluster_plan(bsz, n, m)
        at_once = sk.cluster_capacity(n, m, c, res_rows)
        res["cluster"] = {"blocks_a_pair": c, "resident_rows": res_rows,
                          "of_rows": min(n, m), "clusters_at_once": at_once,
                          "waves": -(-bsz // at_once)}
    res.update(case=f"B={bsz} n={n} m={m} f32 diameter={diameter}",
               route=route, shape_route=sk.sinkhorn_route(n, m),
               kernel_ms=t_k, plain_ms=t_p, library_ms=None,
               pairs_per_s=bsz / t_k["median"] * 1e3,
               **sinkhorn_bound(cost, diam),
               loop_only={**modes[False], "kernel_ms": t_l,
                          "bound_ms": sinkhorn_bound(cost, diam, extrapolate=False)[
                              "bound_ms"]})
    return res


def f64_witness(name, kernel, plain, exact) -> dict:
    """OT scores of the kernel and of the PyTorch solver in f32 against the
    PyTorch solver in f64 on the same reps.  A score is a plan-weighted sum
    of costs with the plan exp((f + g - C) / blur): an f32 rounding of a
    cost or a potential near 60 (4e-6) is 1e-4 of a plan entry at blur 0.05,
    so two f32 solvers part by ~1e-5 of a score.  The kernel may be no more
    than twice the f32 solver's distance from f64, plus 1e-3."""
    err_k = float((kernel.double() - exact).abs().max())
    err_p = float((plain.double() - exact).abs().max())
    if not err_k <= 2 * err_p + 1e-3:
        raise AssertionError(f"{name}: the kernel is {err_k} from f64, the plain "
                             f"f32 solver {err_p}")
    return {"kernel_max_abs_err": err_k, "plain_f32_max_abs_err": err_p,
            "score_max_abs": float(exact.abs().max())}


# tests/test_torch_sinkhorn_one_atom.py: at B=4 pairs of 1 x 1,024
# (`sinkhorn_inputs`' draw, diameter 'pair') the nearer of the JAX package's
# two f32 solvers (XLA; Pallas in interpret mode read 9.15e-3) lies this far
# from the port's f64 solver on the CPU
TEST_TORCH_SINKHORN_ONE_ATOM_JAX_F32 = 8.71e-3


def reference_witness(name, kernel, plain, exact, reference) -> dict:
    """`f64_witness`'s formula with the reference's f32 error as the
    yardstick: the kernel's OT scores no more than twice `reference` (the JAX
    package's f32 distance from f64 on the same reps, measured on the CPU)
    from f64, plus 1e-3.  The f32 PyTorch solver's distance is printed
    beside it."""
    err_k = float((kernel.double() - exact).abs().max())
    err_p = float((plain.double() - exact).abs().max())
    if not err_k <= 2 * reference + 1e-3:
        raise AssertionError(f"{name}: the kernel is {err_k} from f64, the JAX "
                             f"package's f32 solvers {reference}")
    return {"kernel_max_abs_err": err_k, "plain_f32_max_abs_err": err_p,
            "jax_f32_max_abs_err": reference,
            "yardstick": "tests/test_torch_sinkhorn_one_atom.py",
            "score_max_abs": float(exact.abs().max())}


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
    if dtype == torch.float32:
        # the rows with a real key (the fully padded one is uniform in f32,
        # where -1e9 + s rounds to -1e9, but not in f64)
        q64, k64, v64 = (x[:b - 1].double() for x in (q, k, v))
        s64 = q64 @ k64.transpose(-1, -2) * scale + bias[:b - 1, None, None, :].double()
        res["f64_max_abs_err"] = f64_errors(
            f64=torch.softmax(s64, dim=-1) @ v64, kernel=out[:b - 1], plain=want[:b - 1])
        del s64
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
                product_peak(dtype)))
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
    # a data rank's planes: counted from plane0 (its first example x heads)
    plane0 = b * nh
    keep_o = ak.attention_keep_mask(q.shape, p, seed=seed, site=site,
                                    device=dev, plane0=plane0)
    probe_o = ak.fused_attention(q, k, eye, torch.zeros_like(bias), scale, p,
                                 seed=seed, site=site, plane0=plane0)
    if not torch.equal((probe_o[..., :len(cols)] != 0) & probs_pos,
                       keep_o[..., :len(cols)] & probs_pos) \
            or torch.equal(keep_o, keep):
        raise AssertionError("attention_dropout: kernel mask != philox mask "
                             "at plane0")
    res_o = check_close("attention_dropout (plane0)", ak.fused_attention(
        q, k, v, bias, scale, p, seed=seed, site=site, plane0=plane0),
        ak.fused_attention_plain(q, k, v, bias, scale, p, keep_o), atol=tol)
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
        bits_max_abs_err=res_b["max_abs_err"],
        plane0_max_abs_err=res_o["max_abs_err"], keep_rate=keep_rate,
        masks_equal=True,
        kernel_ms=cuda_ms(lambda: ak.fused_attention(
            q, k, v, bias, scale, p, seed=seed, site=site)),
        plain_ms=cuda_ms(lambda: ak.fused_attention_plain(
            q, k, v, bias, scale, p, keep)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=p, scale=scale)),
        **bound(4.0 * b * nh * t * hd * size + 4.0 * b * t,
                4.0 * b * nh * t * t * hd,
                product_peak(dtype)))
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
        # a data rank's planes, counted from plane0
        keep_o = ak.attention_keep_mask(q.shape, p, seed=seed, site=site,
                                        device=dev, plane0=b * nh)
        compare("philox plane0", grads(lambda q_, k_, v_: ak.fused_attention(
            q_, k_, v_, bias, scale, p, seed=seed, site=site, plane0=b * nh)),
            grads(lambda q_, k_, v_: ak.fused_attention_plain(
                q_, k_, v_, bias, scale, p, keep_o)), grads_f32(keep_o))
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
    f64 = {}
    if dtype == torch.float32:
        f64 = {"f64_max_abs_of_max": bwd_f64_errors(
            q, k, v, bias, g, scale, p, keep if p > 0 else None, got,
            grads(lambda q_, k_, v_: ak.fused_attention_plain(
                q_, k_, v_, bias, scale, p, keep if p > 0 else None)))}

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
               max_abs_limit_of_max=norm_tol["abs_of_max"], **f64)
    res.update(
        case=f"[{b},{nh},{t},{hd}] {str(dtype).split('.')[-1]} p={p}",
        kernel_ms=bwd_ms(out_k), plain_ms=bwd_ms(out_p),
        library_ms=bwd_ms(out_l),
        # reads q, k, v, g, the forward's output and two floats a row,
        # writes dq, dk, dv; five products of 2 t t hd
        **bound(8.0 * b * nh * t * hd * size + 4.0 * b * t + 8.0 * b * nh * t,
                10.0 * b * nh * t * t * hd,
                product_peak(dtype)))
    return res


def bwd_f64_errors(q, k, v, bias, g, scale, p, keep, kernel, plain) -> dict:
    """The largest error of the kernel's and of the f32 plain version's dq,
    dk, dv against an f64 backward of the same inputs and mask, over the
    largest f64 value (the worst of the three), the fully padded example
    left out (uniform in f32, where -1e9 + s rounds to -1e9, but not in
    f64).  Reported beside check_norm's limit, which holds the kernel to the
    f32 plain version, whose own error is of the same order."""
    leaves = [x.detach().double().requires_grad_(True) for x in (q, k, v)]
    s = leaves[0] @ leaves[1].transpose(-1, -2) * scale + bias.double()[:, None, None, :]
    probs = torch.softmax(s, dim=-1)
    if keep is not None:
        probs = torch.where(keep, probs / (1.0 - p), torch.zeros_like(probs))
    (probs @ leaves[2]).backward(g.double())
    n = q.shape[0] - 1
    out = {"kernel": 0.0, "plain": 0.0}
    for x, a_, b_ in zip(leaves, kernel, plain):
        ref = x.grad[:n]
        peak = float(ref.abs().max())
        out["kernel"] = max(out["kernel"], float((a_[:n].double() - ref).abs().max()) / peak)
        out["plain"] = max(out["plain"], float((b_[:n].double() - ref).abs().max()) / peak)
    del s, probs, leaves
    return out


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
    # a data rank's rows: the Philox rows counted from row0, forward and back
    row0 = 3 * rows
    keep_o = dk.keep_mask(x.shape, p, seed=seed, site=site, device=dev,
                          row0=row0)
    xr = x.clone().requires_grad_(True)
    out_o = dk.fused_dropout(xr, p, seed=seed, site=site, row0=row0)
    out_o.backward(g)
    if differs(out_o.detach(), dk.dropout_plain(x, keep_o, p)) \
            or differs(xr.grad, dk.dropout_plain(g, keep_o, p)) \
            or torch.equal(keep_o, keep):
        raise AssertionError("dropout: kernel != plain version at row0")
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

    # weights of the size BERT's initialiser gives (std 0.02) at 768 wide;
    # at other widths scaled so that pre-activations stay O(1)
    ws = 0.02 * math.sqrt(768.0 / h)
    return (arr(rows, h), arr(h, f, scale=ws), arr(f, scale=0.02),
            arr(f, h, scale=0.02 * math.sqrt(3072.0 / f)), arr(h, scale=0.02))


def case_ffn(rows, dtype, dev, h=768, f=3072) -> dict:
    """K3 through the model's entry ([out, in] weights, as nn.Linear keeps
    them) and through the public [in, out] one, against the plain version."""
    from aspire_tpu_torch.ops import ffn_kernel as fk
    x, w1, b1, w2, b2 = ffn_inputs(rows, dtype, 13 + rows + h, dev, h, f)
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()      # [out, in]
    out = fk.fused_ffn_linear(x, w1t, b1, w2t, b2)
    torch.cuda.synchronize()
    want = fk.fused_ffn_plain(x, w1, b1, w2, b2)
    # bf16: one rounding of the activation and one of the output a side; a
    # flipped activation ulp moves an O(0.3) output by far less than 2e-2.
    # f32: sums of h and f terms in another order.
    tol = dict(atol=2e-2) if dtype == torch.bfloat16 else dict(atol=1e-4)
    res = check_close("ffn", out, want, **tol)
    if dtype == torch.float32:
        pre = x.double() @ w1.double() + b1.double()
        res["f64_max_abs_err"] = f64_errors(
            f64=F.gelu(pre, approximate="none") @ w2.double() + b2.double(),
            kernel=out, plain=want)
        del pre
    if not torch.equal(out, fk.fused_ffn(x, w1, b1, w2, b2)):
        raise AssertionError("ffn: the [in, out] entry differs from the [out, in] one")
    size = x.element_size()
    res.update(
        case=f"rows={rows} {h}->{f}->{h} {str(dtype).split('.')[-1]}",
        kernel_ms=cuda_ms(lambda: fk.fused_ffn_linear(x, w1t, b1, w2t, b2)),
        plain_ms=cuda_ms(lambda: fk.fused_ffn_plain(x, w1, b1, w2, b2)),
        library_ms=cuda_ms(lambda: F.linear(
            F.gelu(F.linear(x, w1t, b1), approximate="none"), w2t, b2)),
        **bound(size * (2.0 * rows * h + 2.0 * h * f + h + f),
                4.0 * rows * h * f,
                product_peak(dtype)))
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


def _scan_queries(bsz, qmax, seed, dev, lens="uniform"):
    """bsz queries of qmax 768-d sentences and their lengths: uniform in
    [3, qmax], or (lens="abstracts") the aspire-1m-b32 cell's abstracts,
    clip(poisson(9), 3, 20) sentences; one query holds 10."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((bsz, qmax, 768)).astype(
        np.float32) * 2.0).to(dev)
    drawn = rng.integers(3, qmax + 1, bsz) if lens == "uniform" else \
        np.clip(rng.poisson(9, bsz), 3, min(20, qmax))
    q_lens = torch.from_numpy(drawn).to(dev)
    if bsz == 1:
        q_lens[:] = 10
    return q, q_lens


def _by_docs(fn, n: int, chunk: int):
    """fn(lo, hi) over the documents [lo, hi) of a bucket in chunks,
    concatenated: a plain version whose [rows, columns] product would not fit
    the card at once."""
    return torch.cat([fn(i, min(i + chunk, n)) for i in range(0, n, chunk)], dim=0)


def case_scan_bf16(bucket, label, dev, qmax=16, q_n=10) -> dict:
    """K8 on one bf16 (or f32) bucket, as the TPU kernel computes it (no
    qadd) and as the index needs it (qadd = -|q_j|^2 inside the max).  A
    query of full column groups (65 or more sentences) runs csrc/scan_int8.cu's
    bf16 kernel, narrower ones csrc/scan.cu's; either way one launch."""
    from aspire_tpu_torch.ops import scan_kernel as sk
    sents, norms = bucket["sents"], bucket["norms"]
    n, s, d = sents.shape
    q = _scan_queries(1, qmax, 53 + s, dev)[0][0]
    qadd = -(q * q).sum(dim=1)
    live = bucket["doc_idx"] >= 0
    cap = sk.query_cap(sents.dtype, d)
    groups = -(-qmax // cap)
    wide = sents.dtype == torch.bfloat16 and sk.scan_wide(groups, min(qmax, cap), d)
    fn = sk.fused_l2max_scan
    # bf16 operands are exact in f32 on both sides (f32 rows: true f32 on
    # both); sums of 768 products of O(4) values in another order, against
    # scores of O(1e3)
    tol = dict(atol=1e-2, rtol=1e-4)
    before = (fn.launches, fn.wide_launches)
    got = fn(sents, q, norms, q_n)
    torch.cuda.synchronize()
    if (fn.launches - before[0], fn.wide_launches - before[1]) != ((0, 1) if wide else (1, 0)):
        raise AssertionError(f"scan_bf16: {qmax} query sentences did not run the "
                             f"{'wide' if wide else 'narrow'} kernel once")
    want = sk.fused_l2max_scan_plain(sents, q, norms, q_n)
    res = check_close("scan_bf16", got, want, mask=live, **tol)
    if not bool((got[~live] <= sk.NEG).all()):
        raise AssertionError("scan_bf16: a padded document scored")
    got_q = fn(sents, q, norms, q_n, qadd)
    res_q = check_close("scan_bf16 qadd", got_q,
                        sk.fused_l2max_scan_plain(sents, q, norms, q_n, qadd),
                        mask=live, **tol)
    qb = q.to(sents.dtype)
    dtype = str(sents.dtype).split(".")[-1]

    def library():
        sims = torch.einsum("nsd,qd->nsq", sents, qb[:q_n]).float()
        return (2.0 * sims - norms[:, :, None]).amax(dim=(1, 2))

    res.update(
        case=f"{label}: [{n},{s},{d}] {dtype}, {q_n} of {qmax} query sentences",
        query_groups=groups,
        source="aspire_tpu_torch/csrc/" + ("scan_int8.cu" if wide else "scan.cu"),
        qadd_max_abs_err=res_q["max_abs_err"],
        kernel_ms=cuda_ms(lambda: fn(sents, q, norms, q_n, qadd)),
        plain_ms=cuda_ms(lambda: sk.fused_l2max_scan_plain(sents, q, norms, q_n, qadd)),
        library_ms=cuda_ms(library),
        **bound(sents.element_size() * (n * s * d + qmax * d) + 4.0 * n * s + 4.0 * n,
                2.0 * n * s * d * qmax,
                product_peak(sents.dtype)))
    return res


def _check_pack(sents, scales, norms, q, q_lens, qmax, got) -> dict:
    """K7's packing (`pack_kernel`) on the card against its plain version: a
    wide launch into buffers of its own gives `got` bit for bit, and its
    packed query, qadd and plan over the live groups equal
    `pack_queries_plain`'s, the plan's header (live groups, their columns,
    the real sentences) `pack_plan`'s on the lengths."""
    from aspire_tpu_torch.ops import scan_kernel as sk
    n, s, d = sents.shape
    sms = torch.cuda.get_device_properties(sents.device).multi_processor_count
    launch = sk.launch_plan(sents.dtype, n, s, d, q.shape[0], qmax, sms)
    bound, unit = launch.groups, sk.pack_unit(launch, s)
    scratch = sk.pack_buffers(bound, d, sents.device)
    qf = q.float()
    qadd = -(qf * qf).sum(dim=2)
    again = sk._launch("aspire_scan_int8", sents, scales, norms, qf, qadd, q_lens, scratch)
    packed, qa, table = (t.cpu() for t in scratch)
    want_packed, want_qa, want_plan = sk.pack_queries_plain(qf.cpu(), qadd.cpu(), q_lens.cpu(),
                                                            unit=unit)
    lens = q_lens.cpu().clamp(0, qmax).tolist()
    units = sk.pack_plan(lens, qmax, unit)
    head = [len(units), 128 * len(units), sum(lens)]
    cols = head[1]
    faults = [what for what, ok in (
        ("scores", torch.equal(again, got)),
        ("header", table[:sk.PLAN_HEAD].tolist() == head),
        ("plan", torch.equal(table[:want_plan.numel()], want_plan)),
        ("packed query", torch.equal(packed[:cols], want_packed)),
        ("qadd", torch.equal(qa[:cols], want_qa))) if not ok]
    if faults:
        raise AssertionError(f"scan_int8 packing: {', '.join(faults)} differ from "
                             f"pack_queries_plain's (lengths {lens})")
    return {"live_groups": head[0], "group_bound": bound, "sentences": head[2],
            "columns": cols, "unit": unit}


def case_scan_int8(bucket, label, bsz, dev, qmax=16, doc_chunk=None,
                   lens="uniform") -> dict:
    """K7 on one int8 bucket against its plain version (and the library call)
    computed `doc_chunk` documents at a time where given; queries of
    `_scan_queries`' `lens`.  A wide launch of one group a query has its
    packing checked too (`_check_pack`)."""
    from aspire_tpu_torch.ops import scan_kernel as sk
    sents, scales, norms = bucket["sents"], bucket["scales"], bucket["norms"]
    n, s, d = sents.shape
    q, q_lens = _scan_queries(bsz, qmax, 59 + bsz + s, dev, lens)
    live = bucket["doc_idx"] >= 0
    fn = sk.fused_l2max_scan_int8_batched
    docs = doc_chunk or n
    # more query sentences than a launch takes: the groups join the batch
    rows, groups = sk.int8_groups(qmax, d)
    wide = sk.scan_wide(bsz * groups, rows, d)
    before = (fn.launches, fn.wide_launches)
    got = fn(sents, scales, norms, q, q_lens, qmax)
    torch.cuda.synchronize()
    if (fn.launches - before[0], fn.wide_launches - before[1]) != ((0, 1) if wide else (1, 0)):
        raise AssertionError(f"scan_int8: B={bsz} x {qmax} did not run the "
                             f"{'wide' if wide else 'narrow'} kernel")
    chunk = 8                                   # bounds the plain [rows, B qmax] f32

    def plain():
        return _by_docs(lambda a, b: torch.cat([sk.fused_l2max_scan_int8_batched_plain(
            sents[a:b], scales[a:b], norms[a:b], q[i:i + chunk], q_lens[i:i + chunk], qmax)
            for i in range(0, bsz, chunk)], dim=1), n, docs)

    want = plain()
    # int8 and bf16 operands are exact in f32 on both sides; sums of 768
    # products in another order, times a scale, against scores of O(1e3)
    res = check_close("scan_int8", got[live], want[live], atol=1e-2, rtol=2e-4)
    if not bool((got[~live] <= 0.5 * sk.NEG).all()):
        raise AssertionError("scan_int8: a padded document scored")
    if wide and groups == 1:
        res["packing"] = _check_pack(sents, scales, norms, q, q_lens, qmax, got)
    qb = q.to(torch.bfloat16).reshape(bsz * qmax, d)

    def library():
        def part(a, b):
            rows_b = sents[a:b].reshape(-1, d).to(torch.bfloat16)
            out = []
            for i in range(0, bsz, chunk):
                cols = qb[i * qmax:(i + chunk) * qmax]
                sims = torch.matmul(rows_b, cols.t()).float()
                sc = 2.0 * scales[a:b].reshape(-1, 1) * sims - norms[a:b].reshape(-1, 1)
                out.append(sc.reshape(b - a, s, -1, qmax).amax(dim=(1, 3)))
            return torch.cat(out, dim=1)
        return _by_docs(part, n, docs)

    res.update(
        case=f"{label}: [{n},{s},{d}] int8, B={bsz} qmax={qmax}"
             + ("" if lens == "uniform" else f", {lens}' lengths"),
        query_groups=groups,
        source="aspire_tpu_torch/csrc/" + ("scan_int8.cu" if wide else "scan.cu"),
        kernel_ms=cuda_ms(lambda: sk.fused_l2max_scan_int8_batched(
            sents, scales, norms, q, q_lens, qmax)),
        plain_ms=cuda_ms(plain),
        library_ms=cuda_ms(library),
        **bound(1.0 * n * s * d + 8.0 * n * s + 2.0 * bsz * qmax * d
                + 4.0 * n * bsz, 2.0 * n * s * d * bsz * qmax, PEAK_BF16))
    return res


def long_bucket(dev, n=840, s=1200, lo=801, pad_docs=4, seed=47) -> dict:
    """One bucket of full-text documents, the shape of the long index's last
    bucket: n documents of lo..s sentences of 768-d reps (lengths from numpy
    seed `seed`, reps drawn on the card by a generator seeded `seed`), zero
    pad rows with +inf norms, the last `pad_docs` documents pads only
    (doc_idx -1); bf16 rows and their norms, and the int8 form from
    quantize_sentences with the norms of the stored vectors."""
    from aspire_tpu_torch.index.dense import quantize_sentences
    lens = np.random.default_rng(seed).integers(lo, s + 1, n)
    lens[n - pad_docs:] = 0
    lens_t = torch.from_numpy(lens).to(dev)
    live = torch.arange(s, device=dev)[None, :] < lens_t[:, None]
    gen = torch.Generator(device=dev).manual_seed(seed)
    reps = torch.randn((n, s, 768), generator=gen, device=dev) * 2.0 * live[:, :, None]
    inf = torch.tensor(float("inf"), device=dev)
    doc_idx = torch.where(lens_t > 0, torch.arange(n, device=dev), -1)
    sents = reps.to(torch.bfloat16)
    norms = torch.where(live, (sents.float() ** 2).sum(dim=2), inf)
    xi, sc = quantize_sentences(reps)
    del reps
    norms8 = torch.where(live, (xi.float() ** 2).sum(dim=2) * sc * sc, inf)
    return {"bfloat16": {"sents": sents, "norms": norms, "doc_idx": doc_idx},
            "int8": {"sents": xi, "scales": sc, "norms": norms8, "doc_idx": doc_idx}}


def phase_kernels(dev) -> dict:
    """Runs every case; the first case of each kernel is its main path's shape
    (serving for the first three, training for the rest, the f32 training
    step for the f32 attention kernels) and feeds the contract line.  Attention [3,12,512,64] and the FFN at 1536 rows are what
    the training path's dev check gives the deterministic kernels."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = {
        # a request's 16 pairs, a training step's 30 (groups of 3), a fused
        # batch of 32 queries at k=64
        "sinkhorn": [case_sinkhorn(16, "global", dev),
                     case_sinkhorn(30, "grouped", dev),
                     case_sinkhorn(50, "global", dev),
                     case_sinkhorn(1024, "global", dev),
                     case_sinkhorn(1024, "pair", dev),
                     case_sinkhorn(2048, "pair", dev)],
        "attention": [case_attention(16, 12, 256, 64, bf16, dev),
                      case_attention(3, 12, 512, 64, bf16, dev),
                      case_attention(4, 12, 512, 64, bf16, dev),
                      case_attention(16, 12, 256, 64, f32, dev),
                      case_attention(4, 12, 512, 64, f32, dev),
                      case_attention(2, 12, 200, 64, bf16, dev),
                      case_attention(4, 4, 128, 32, bf16, dev),
                      case_attention(2, 4, 64, 8, bf16, dev)],
        "ffn": [case_ffn(4096, bf16, dev), case_ffn(16384, bf16, dev),
                case_ffn(1536, bf16, dev), case_ffn(4059, bf16, dev),
                case_ffn(1000, bf16, dev, 1024, 4096),
                case_ffn(37, bf16, dev, 32, 64),
                case_ffn(4096, f32, dev), case_ffn(1001, f32, dev, 64, 256)],
        # the training shape first: 30 sequences of 512 tokens an encode
        "attention_dropout": [
            case_attention_dropout(30, 12, 512, 64, bf16, dev),
            case_attention_dropout(16, 12, 256, 64, bf16, dev),
            case_attention_dropout(4, 12, 512, 64, bf16, dev),
            case_attention_dropout(2, 12, 200, 64, bf16, dev),
            case_attention_dropout(4, 4, 128, 32, bf16, dev),
            case_attention_dropout(2, 4, 64, 8, bf16, dev)],
        # f32 (training with --no-bf16-compute): the training shape first
        "attention_dropout_f32": [
            case_attention_dropout(30, 12, 512, 64, f32, dev),
            case_attention_dropout(4, 12, 512, 64, f32, dev),
            case_attention_dropout(2, 12, 200, 64, f32, dev)],
        "attention_bwd": [
            case_attention_bwd(30, 12, 512, 64, bf16, dev),
            case_attention_bwd(30, 12, 512, 64, bf16, dev, p=0.0),
            case_attention_bwd(16, 12, 256, 64, bf16, dev),
            case_attention_bwd(4, 12, 512, 64, bf16, dev),
            case_attention_bwd(2, 12, 200, 64, bf16, dev),
            case_attention_bwd(2, 12, 200, 64, bf16, dev, p=0.0),
            case_attention_bwd(4, 4, 128, 32, bf16, dev),
            case_attention_bwd(4, 4, 128, 32, bf16, dev, p=0.0),
            case_attention_bwd(2, 4, 64, 8, bf16, dev),
            case_attention_bwd(2, 4, 64, 8, bf16, dev, p=0.0)],
        "attention_bwd_f32": [
            case_attention_bwd(30, 12, 512, 64, f32, dev),
            case_attention_bwd(30, 12, 512, 64, f32, dev, p=0.0),
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
    tiny_encode(dev)
    for name, rows in range_kernel_cases(dev).items():
        cases[name] = rows
        emit("kernel_cases", kernel=name, cases=rows)
    return cases


def range_kernel_cases(dev) -> dict:
    """The kernels' input ranges past the 64-wide heads, one block's Sinkhorn
    pair and 128 query sentences, each against its plain version; the first
    case of each wide or large kernel is the ranges phase's shape (a
    BERT-base encode with 6 heads of 128; the rank CLI's 24-sentence queries
    against candidates of up to 1,200 sentences; an abstract's 20-sentence
    query against 20 candidates of up to 800 for K1's wide pairs).  The scans
    at 300 query sentences, their groups as extra column groups of one launch
    (K8 on csrc/scan_int8.cu's bf16 kernel, K7 on its int8 one), on a bucket
    of the long index's shape (`long_bucket`) and on one of 4,000 documents of
    up to 24 sentences."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = {
        "attention_wide": [case_attention(16, 6, 256, 128, bf16, dev),
                           case_attention(4, 8, 512, 96, bf16, dev),
                           case_attention(4, 4, 512, 192, bf16, dev),
                           case_attention(2, 3, 512, 256, bf16, dev)],
        "attention_dropout_wide": [case_attention_dropout(30, 6, 512, 128, bf16, dev),
                                   case_attention_dropout(4, 8, 512, 96, bf16, dev),
                                   case_attention_dropout(4, 4, 512, 192, bf16, dev),
                                   case_attention_dropout(4, 3, 512, 256, bf16, dev)],
        "attention_bwd_wide": [case_attention_bwd(30, 6, 512, 128, bf16, dev),
                               case_attention_bwd(4, 6, 512, 128, bf16, dev, p=0.0),
                               case_attention_bwd(4, 8, 512, 96, bf16, dev),
                               case_attention_bwd(4, 4, 512, 192, bf16, dev),
                               case_attention_bwd(4, 3, 512, 256, bf16, dev),
                               case_attention_bwd(2, 3, 200, 256, bf16, dev, p=0.0)],
        # f32 (the evaluation's encode; training with --no-bf16-compute): the
        # ranges encode's and step's shapes first
        "attention_wide_f32": [case_attention(16, 6, 256, 128, f32, dev),
                               case_attention(4, 4, 512, 192, f32, dev),
                               case_attention(2, 3, 200, 256, f32, dev)],
        "attention_dropout_wide_f32": [case_attention_dropout(30, 6, 512, 128, f32, dev),
                                       case_attention_dropout(4, 6, 512, 128, f32, dev),
                                       case_attention_dropout(4, 4, 512, 192, f32, dev),
                                       case_attention_dropout(2, 3, 200, 256, f32, dev)],
        "attention_bwd_wide_f32": [case_attention_bwd(30, 6, 512, 128, f32, dev),
                                   case_attention_bwd(4, 6, 512, 128, f32, dev),
                                   case_attention_bwd(4, 6, 512, 128, f32, dev, p=0.0),
                                   case_attention_bwd(4, 4, 512, 192, f32, dev),
                                   case_attention_bwd(2, 3, 200, 256, f32, dev)],
        # then the fused queries' reranks (a 300-sentence query's 20
        # candidates of up to 1,200; a batch of 8 such queries) and a pair
        # whose slices do not fit the blocks' shared memory
        "sinkhorn_large": [case_sinkhorn(16, "pair", dev, 24, 1200),
                           case_sinkhorn(16, "pair", dev, 300, 1200),
                           case_sinkhorn(16, "pair", dev, 240, 240),
                           case_sinkhorn(16, "pair", dev, 512, 512),
                           case_sinkhorn(30, "grouped", dev, 300, 300),
                           case_sinkhorn(20, "pair", dev, 300, 1200),
                           case_sinkhorn(160, "pair", dev, 300, 1200),
                           case_sinkhorn(16, "pair", dev, 1200, 1200)],
        # the wide pairs: an abstract's query reranked against 20 and a batch
        # of 8 queries against 160 full-text candidates of up to 800
        # sentences (the ranges path's shapes), then square pairs at a
        # request's batch and at a fused batch's; the route's two edges at
        # B=16, which the route gives the cluster kernel (faster there), and
        # at B=140, where it keeps them; a pair with no table of rounds (226
        # x 255), one turned (1,024 x 55) and two of a single atom (33 x 1,
        # and 1 x 1,024 held to the JAX package's f32 error)
        "sinkhorn_wide": [case_sinkhorn(20, "pair", dev, 20, 800),
                          case_sinkhorn(160, "pair", dev, 20, 800),
                          case_sinkhorn(16, "pair", dev, 48, 40),
                          case_sinkhorn(1024, "pair", dev, 48, 40),
                          case_sinkhorn(16, "pair", dev, 100, 100),
                          case_sinkhorn(16, "pair", dev, 239, 239),
                          case_sinkhorn(16, "pair", dev, 55, 1024),
                          case_sinkhorn(140, "pair", dev, 239, 239),
                          case_sinkhorn(140, "pair", dev, 55, 1024),
                          case_sinkhorn(140, "pair", dev, 226, 255),
                          case_sinkhorn(140, "pair", dev, 1024, 55),
                          case_sinkhorn(4, "pair", dev, 33, 1),
                          case_sinkhorn(4, "pair", dev, 1, 1024,
                                        reference_f64=TEST_TORCH_SINKHORN_ONE_ATOM_JAX_F32)],
    }
    # the scans at 300 query sentences, the long index's bucket of 1,200
    # first: K8 on the wide kernel (three groups of one launch), K7 with the
    # groups as extra queries; an abstract's query of 16 on the same rows
    # (csrc/scan.cu); then one bucket of 4,000 documents of up to 24 sentences
    long = long_bucket(dev)
    label = "the long index's bucket of 1,200"
    cases["scan_bf16_wide"] = [case_scan_bf16(long["bfloat16"], label, dev, qmax=300,
                                              q_n=300)]
    cases["scan_int8_grouped"] = [case_scan_int8(long["int8"], label, 8, dev, qmax=300,
                                                 doc_chunk=105)]
    cases["scan_long_narrow"] = [case_scan_bf16(long["bfloat16"], label, dev),
                                 case_scan_int8(long["int8"], label, 1, dev)]
    del long
    torch.cuda.empty_cache()
    one = build_large_index(dev, 4000, buckets=(24,))["buckets"]
    label = "bucket 24 of 4,000 documents"
    cases["scan_bf16_wide"].append(case_scan_bf16(one["bfloat16"][0], label, dev,
                                                  qmax=300, q_n=300))
    cases["scan_int8_grouped"].append(case_scan_int8(one["int8"][0], label, 8, dev,
                                                     qmax=300))
    del one
    torch.cuda.empty_cache()
    return cases


def tiny_encode(dev) -> dict:
    """BertConfig.tiny() (hidden 32, 4 heads of 8, intermediate 64) encodes on
    the card under 'auto' -- attention with its heads padded to 64 columns,
    the FFN with both widths padded to 64 -- against 'naive', bf16 and f32,
    weights from a numpy seed.  Tolerances: bf16 1e-2 (each path rounds to 8
    bits at its own places, the naive FFN rounds its pre-activation; the
    H100 read 1.3e-3), f32 1e-3."""
    from aspire_tpu_torch.models.bert import BertConfig
    from aspire_tpu_torch.models.convert import state_dict_from_flax_params
    from aspire_tpu_torch.models.encoders import ConSentEncoder
    cfg = BertConfig.tiny()
    state = state_dict_from_flax_params(random_flax_tree(cfg, seed=1), cfg)
    token_ids, attn_mask, sent_ids, _ = make_request(cfg, 5, dev, docs=4, tokens=64,
                                                     max_sents=4)
    rows = []
    for dtype, atol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-3)):
        outs = {}
        for impl in ("auto", "naive"):
            enc = ConSentEncoder(cfg, max_sents=4, dtype=dtype, device=dev,
                                 attention_impl=impl, ffn_impl=impl,
                                 pool_impl=impl).eval()
            enc.load_state_dict(state)
            before = read_counts()
            with torch.inference_mode():
                outs[impl] = enc(token_ids, attn_mask, sent_ids)[1]
            torch.cuda.synchronize()
            outs[impl + "_launches"] = {k: v - before[k] for k, v in read_counts().items()
                                        if v != before[k]}
        got = outs["auto_launches"]
        if got.get("attention") != cfg.num_hidden_layers \
                or got.get("ffn") != ffn_launches(dtype) * cfg.num_hidden_layers \
                or outs["naive_launches"]:
            raise AssertionError(f"tiny encode: launches {got}, naive "
                                 f"{outs['naive_launches']}")
        res = check_close(f"tiny encode {dtype}", outs["auto"], outs["naive"], atol)
        rows.append({"dtype": str(dtype).split(".")[-1], "launches": got, **res})
    emit("tiny_encode", hidden=cfg.hidden_size, heads=cfg.num_attention_heads,
         intermediate=cfg.intermediate_size, layers=cfg.num_hidden_layers,
         docs=4, tokens=64, rows=rows)
    return rows


def phase_pool_kernel(dev) -> list:
    """K4 against its plain version; the first case is the encode's shape."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [case_pool(64, 256, 768, 20, bf16, dev),
             case_pool(64, 256, 768, 20, f32, dev),
             case_pool(3, 200, 768, 20, bf16, dev, ragged=True),
             case_pool(3, 200, 768, 20, f32, dev, ragged=True),
             case_pool(16, 512, 768, 24, bf16, dev),
             # past the 48 KB tile of the first kernel, which refused them
             case_pool(16, 512, 768, 96, bf16, dev),
             case_pool(4, 512, 768, 96, f32, dev, ragged=True)]
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
            "attention_dropout_f32": (fused_attention, "f32_dropout_launches"),
            "attention_bwd_f32": (fused_attention, "f32_bwd_launches"),
            "dropout": (fused_dropout, "launches"),
            "pool": (sentence_pool_fused, "launches"),
            "scan_bf16": (fused_l2max_scan, "launches"),
            "scan_int8": (fused_l2max_scan_int8_batched, "launches"),
            "scan_int8_wide": (fused_l2max_scan_int8_batched, "wide_launches"),
            "scan_bf16_wide": (fused_l2max_scan, "wide_launches"),
            "attention_wide": (fused_attention, "wide_launches"),
            "attention_dropout_wide": (fused_attention, "wide_dropout_launches"),
            "attention_bwd_wide": (fused_attention, "wide_bwd_launches"),
            "attention_wide_f32": (fused_attention, "f32_wide_launches"),
            "attention_dropout_wide_f32": (fused_attention, "f32_wide_dropout_launches"),
            "attention_bwd_wide_f32": (fused_attention, "f32_wide_bwd_launches"),
            "sinkhorn_large": (sinkhorn_solve, "large_launches"),
            "sinkhorn_wide": (sinkhorn_solve, "wide_launches")}


def ffn_launches(dtype) -> int:
    """Launches of one K3 call: two in bf16, three in f32 (the TF32 split)."""
    from aspire_tpu_torch.ops.ffn_kernel import LAUNCHES
    return LAUNCHES[dtype]


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
    want.update(sinkhorn=1, attention=layers, ffn=ffn_launches(dtype) * layers,
                pool=1)
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


TRAIN_COUNTERS = ("attention_dropout", "attention_bwd", "dropout", "sinkhorn")


def flagship(cfg, dev, impl: str = "auto", dtype=torch.bfloat16):
    """The ts+otAspire training configuration on `cfg`, weights from seed 0,
    activations in `dtype` (bf16 over f32 parameters; f32 is what `train
    --no-bf16-compute` builds); impl 'naive' builds the plain path (naive
    attention, dropout and FFN, the Sinkhorn loop as PyTorch rounds)."""
    from aspire_tpu_torch.core.config import ModelHParams
    from aspire_tpu_torch.models.convert import model_state_dict_from_flax_params
    from aspire_tpu_torch.models.doc_models import build_model
    hp = ModelHParams(model_name="sbalisentbienc",
                      score_aggregation="l2wasserstein", sent_sm_temp=5000.0,
                      sent_loss_prop=1.0, sentsup_loss_prop=1.0,
                      max_seq_len=512, max_sents=20, attention_impl=impl,
                      hidden_dropout_impl=impl, ffn_impl=impl)
    model = build_model(hp, cfg, dtype=dtype, device=dev,
                        ot_solver="torch" if impl == "naive" else "auto")
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


# first training step, kernel path against plain path: the loss (relative) and
# each group's gradient norm (relative).  bf16: both paths round at the same
# places but for the FFN pre-activation and the backward's dprobs,
# independently over 12 layers.  f32: the kernels' products are split TF32 and
# sum in other orders than cuBLAS's f32 products, a few f32 ulps an element;
# at 12 layers the card reads 1.3e-7 in loss and 2.4e-7 in gradient norm.
STEP_TOL = {torch.bfloat16: {"loss_rel": 1e-2, "grad_norm_rel": 0.05},
            torch.float32: {"loss_rel": 1e-5, "grad_norm_rel": 1e-5}}


def kernel_against_plain_step(cfg, dev, superbatch, seed: int,
                              dtype=torch.bfloat16) -> dict:
    """The main path's first step (its model, superbatch and generator seed):
    loss and gradients through the kernels and through the plain path (naive
    attention, dropout and FFN, the plain Sinkhorn loop) fed the same Philox
    masks.  The plain path
    keeps [30, 12, 512, 512] scores, probabilities and masks of every layer
    for its backward."""
    from aspire_tpu_torch.train.trainer import tree_to_device as _to
    sb = _to(superbatch, dev)
    out, peak_mb = {}, {}
    for label, impl in (("kernel", "auto"), ("plain", "naive")):
        torch.cuda.reset_peak_memory_stats()
        _, model = flagship(cfg, dev, impl, dtype)
        loss, _ = model.train_loss_grouped(
            sb, torch.Generator().manual_seed(seed), True)
        loss.backward()
        out[label] = (float(loss.detach()), _group_norms(model))
        peak_mb[label] = torch.cuda.max_memory_allocated() / 2 ** 20
        del model, loss
        torch.cuda.empty_cache()
    (lk, nk), (lp, np_) = out["kernel"], out["plain"]
    tol = STEP_TOL[dtype]
    if not math.isfinite(lk) or abs(lk - lp) > tol["loss_rel"] * abs(lp):
        raise AssertionError(f"train: first-step loss {lk} (kernels) against "
                             f"{lp} (plain path)")
    worst = max(abs(nk[g] - np_[g]) / np_[g] for g in np_)
    if not worst <= tol["grad_norm_rel"]:
        raise AssertionError(f"train: gradient norms differ by {worst}: "
                             f"{nk} against {np_}")
    return {"superbatch": list(sb["query"]["token_ids"].shape),
            "loss_kernel": lk, "loss_plain": lp, "peak_memory_mb": peak_mb,
            "loss_rel_err": abs(lk - lp) / abs(lp), "tolerance": tol,
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
        # dq); 25 dropout sites at 12 layers, forward and backward; the
        # positive and the negative OT distance, one K1 annealing loop each
        want = {"attention_dropout": 2 * layers, "attention_bwd": 2 * 3 * layers,
                "dropout": 2 * 2 * (1 + 2 * layers), "sinkhorn": 2}
        # the dev check came after step 4: three deterministic encodes and
        # its own two distances
        dev_want = {"attention": 3 * layers, "ffn": 2 * 3 * layers, "sinkhorn": 2}
        for i, got in enumerate(per_step):
            with_dev = dev_want if i == 3 else {}
            expect = {k: want.get(k, 0) + with_dev.get(k, 0)
                      for k in (*want, *dev_want)}
            if {k: got[k] for k in expect} != expect:
                raise AssertionError(f"train: step {i} launched {got}, "
                                     f"expected {expect}")
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
                "attention_bwd": 10 * 2 * 2 * 3, "dropout": 10 * 2 * 2 * 5,
                "sinkhorn": 10 * 2}
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


def phase_train_f32(dev, layers: int) -> dict:
    """The f32 training step, the model `train --no-bf16-compute` builds (f32
    activations over f32 parameters; dropout passes through the f32 K5a, K5b
    and K6): the first step against the plain path in f32, then three
    optimizer steps with the launches of each counted."""
    import tempfile
    from aspire_tpu_torch.core.config import RunConfig, TrainHParams
    from aspire_tpu_torch.models.bert import BertConfig
    from aspire_tpu_torch.train.trainer import Trainer
    f32 = torch.float32
    cfg = BertConfig(num_hidden_layers=layers)
    steps = [synth_superbatch(600 + i, 10, 3, 512, 20, cfg.vocab_size) for i in range(3)]
    train_seed = 21
    against_plain = kernel_against_plain_step(cfg, dev, steps[0], train_seed, f32)

    hp, model = flagship(cfg, dev, dtype=f32)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tp = TrainHParams(batch_size=3, accumulated_batch_size=30,
                      update_rule="adam", learning_rate=2e-5,
                      lr_decay_method="warmuplin", num_warmup_steps=20,
                      train_size=3000)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    marks, counts = [], []
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(model, RunConfig(model=hp, train=tp), tmp, fused_accum=True)
        state = trainer.train(trainer.init_state(), _timed(steps, marks, counts),
                              seed=train_seed)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        counts.append(read_counts())
    launches = read_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    # two encodes a step; an f32 backward is two launches (rows, keys); 25
    # dropout sites at 12 layers, forward and backward; one K1 annealing loop
    # for each of the two OT distances; nothing of the bf16 kernels
    want = {"attention_dropout_f32": 2 * layers,
            "attention_bwd_f32": 2 * 2 * layers,
            "dropout": 2 * 2 * (1 + 2 * layers), "sinkhorn": 2,
            "attention_dropout": 0, "attention_bwd": 0}
    for i, (a_, b_) in enumerate(zip(counts[:-1], counts[1:])):
        got = {k: b_[k] - a_[k] for k in want}
        if got != want:
            raise AssertionError(f"train f32: step {i} launched {got}, expected {want}")
    # the trainer pulls the first step's losses (then every fifth step's); a
    # step whose loss is not finite leaves state.step where it was, so step 3
    # is three finite steps
    losses = trainer.loss_history
    if state.step != 3 or len(losses) != 10 \
            or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train f32: step {state.step}, losses {losses}")
    first_loss = sum(losses[:10])
    if abs(first_loss - against_plain["loss_kernel"]) > 1e-4 * abs(first_loss):
        raise AssertionError(
            f"train f32: the first step's loss {first_loss} is not the "
            f"{against_plain['loss_kernel']} held against the plain path")
    after = model.state_dict()
    changed = sum(not torch.equal(before[k], after[k]) for k in before)
    finite = all(bool(torch.isfinite(v).all()) for v in after.values())
    if changed != len(before) or not finite:
        raise AssertionError(f"train f32: {changed} of {len(before)} "
                             f"parameters changed, finite={finite}")
    # the last step's time holds the trainer's closing checkpoint saves
    step_ms = [(b_ - a_) * 1e3 for a_, b_ in zip(marks[:-1], marks[1:])]
    print(f"f32 train: {layers} layers, first step {step_ms[0]:.1f} ms, warm "
          f"step {step_ms[1]:.1f} ms, last step with checkpoints {step_ms[2]:.1f} ms "
          f"(host clock), peak {peak_mb:.1f} MB; {CARD}", flush=True)
    emit("train_f32", model="sbalisentbienc l2wasserstein", dtype="float32",
         layers=layers, hidden=cfg.hidden_size, heads=cfg.num_attention_heads,
         superbatch=[10, 3, 512], max_sents=20, optimizer="adam warmuplin",
         first_step_ms=step_ms[0], warm_step_ms=step_ms[1],
         last_step_with_checkpoints_ms=step_ms[2], peak_memory_mb=peak_mb, launches_per_step=want, launches=launches,
         first_losses=losses, first_step_loss=first_loss, steps=state.step,
         kernel_path_against_plain_path=against_plain, card=CARD)
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
    want.update(attention=2 * batches * layers, ffn=2 * 2 * batches * layers,
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


def _stage_ms(call, calls: int = 5,
              stages=("scan", "gather", "rerank")) -> dict:
    """The fused query's stages as its own spans time them (device ms a
    call, mean over `calls` calls of the entry under `recording()`; no
    synchronise between the stages)."""
    from aspire_tpu_torch.utils import profiling
    profiling.reset()
    with profiling.recording():
        for _ in range(calls):
            call()
    spent = profiling.summary()
    profiling.reset()
    return {f"{name}_ms": spent[name]["device_ms"] / calls for name in stages}


def build_large_index(dev, n_docs: int, buckets=(12, 24),
                      storages=("bfloat16", "int8"), save_dir=None) -> dict:
    """A dense-bucket index in each of `storages` of n_docs documents of
    clip(poisson(9), 3, 20) sentences of 768-d reps, built by
    build_dense_index from numpy reps (seed 0) and put on the card (dev
    None: left on the host); save_dir: each also saved under
    save_dir/<storage> (the mesh phase's ranks map those files)."""
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
        if dev is not None:
            big["buckets"][name] = idx.device_arrays(dev)
            big["pos"][name] = idx.device_pos_arrays(dev)
        if save_dir is not None:
            t0 = time.perf_counter()
            idx.save(pathlib.Path(save_dir) / name)
            host_s[f"save_{name}"] = time.perf_counter() - t0
        big["stored"][name] = sum(a.nbytes for b in idx.buckets
                                  for a in b.values())
        del idx
    big["host_seconds"] = host_s
    return big


def scan_kernel_cases(big: dict, dev) -> dict:
    """K8 and K7 against their plain versions on the large index's buckets;
    the first case of each is the query path's shape.  K7 runs two kernels,
    chosen by shape (`scan_wide`): csrc/scan.cu's for the single query
    (first case B=1) and four queries of 16, csrc/scan_int8.cu's for full
    column groups (first case the batch of 32; B=5 x 20 sentences; the
    aspire-1m-b32 cell's batch, 32 abstracts' queries padded to 24, on every
    bucket, its packing checked)."""
    int8 = big["buckets"]["int8"]
    label = lambda b: f"bucket {b['sents'].shape[1]}"
    cases = {"scan_bf16": [case_scan_bf16(b, label(b), dev)
                           for b in big["buckets"]["bfloat16"]],
             "scan_int8": [case_scan_int8(b, label(b), 1, dev) for b in int8]
             + [case_scan_int8(int8[0], label(int8[0]), 4, dev)],
             "scan_int8_wide": [case_scan_int8(b, label(b), 32, dev) for b in int8]
             + [case_scan_int8(int8[0], label(int8[0]), 5, dev, qmax=20)]
             + [case_scan_int8(b, label(b), 32, dev, qmax=24, lens="abstracts")
                for b in int8]}
    # K8 on f32 rows: the bf16 bucket 12 in f32 (exact), true-f32 products
    b12 = big["buckets"]["bfloat16"][0]
    cases["scan_bf16"].append(case_scan_bf16(
        dict(b12, sents=b12["sents"].float()), "bucket 12 in f32", dev))
    torch.cuda.empty_cache()
    for name, rows in cases.items():
        emit("kernel_cases", kernel=name, cases=rows)
    return cases


def index_query_inputs(n_docs: int, d: int = 768):
    """The index path's queries (numpy seed 1): 32 queries of 3-16 sentences
    padded to 16 (the first of 10), and 8 pools of 512 ids, the last 12 of
    each a pad slot."""
    qrng = np.random.default_rng(1)
    q_lens = qrng.integers(3, 17, 32)
    q_lens[0] = 10
    q = qrng.standard_normal((32, 16, d)).astype(np.float32) * 2
    q *= (np.arange(16)[None, :] < q_lens[:, None])[:, :, None]
    cand = qrng.integers(0, n_docs, (8, 512)).astype(np.int32)
    cand[:, 500:] = -1
    return q, q_lens, cand


def index_queries(big: dict, dev):
    """Fused queries (single bf16 at k=50, single int8 at k=64, a batch of 32
    int8 at k=64) and one pool ranking (8 queries x 512 ids, OT) through the
    kernels.  Returns a function that, called after the launch counts are
    read, runs the same through the plain route (scan='torch',
    solver='torch'), compares, reads the stages' spans and prints the line."""
    from aspire_tpu_torch.index.dense import flatten_device_buckets
    from aspire_tpu_torch.index.serve import (make_fused_query,
                                              make_fused_query_batched,
                                              make_pool_rank_batched)
    n_docs, d = big["docs"], big["dim"]
    nb = len(big["buckets"]["int8"])        # a bucket size no document has is left out
    q_np, q_lens_np, cand_np = index_query_inputs(n_docs, d)
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
            row.update(_stage_ms(lambda: call(fn_k)))
            row["plain_route"] = {**t_p, **_stage_ms(lambda: call(fn_p), calls=2)}
            row["kernel_against_plain"] = compare_answers(label, out_k, out_p)
        later.append(after)

    drive("single bf16", "bfloat16", 1, 50, {"scan_bf16": nb, "sinkhorn": 1})
    drive("single int8", "int8", 1, 64, {"scan_int8": nb, "sinkhorn": 1})
    drive("batch of 32 int8", "int8", 32, 64, {"scan_int8_wide": nb, "sinkhorn": 1})

    cand = torch.from_numpy(cand_np).to(dev)
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


def index_f32_query(dev, n_docs: int = 20_000) -> dict:
    """A float32 dense-bucket index (clip(poisson(9), 3, 20) sentences of
    768-d reps, seed 3, buckets (12, 24)) queried with document 7's own
    sentences through the scan kernel (its f32 instantiation) and through the
    plain product: document 7 first, the same ids wherever neighbouring
    scores are apart, scores within 1e-3 + 2e-4 relative."""
    from aspire_tpu_torch.index.dense import (build_dense_index,
                                              flatten_device_buckets,
                                              make_dense_search)
    from aspire_tpu_torch.ops.scan_kernel import fused_l2max_scan
    rng = np.random.default_rng(3)
    lens = np.clip(rng.poisson(9, n_docs), 3, 20)
    reps = [rng.standard_normal((n, 768), dtype=np.float32) * 2 for n in lens]
    idx = build_dense_index(reps, list(range(n_docs)), buckets=(12, 24),
                            dtype="float32")
    flat = flatten_device_buckets(idx.device_arrays(dev))
    nb = len(idx.buckets)
    q, q_len = _pad_query(reps[7], 16, dev)
    before = fused_l2max_scan.launches
    v_k, d_k = make_dense_search(nb, k=20, scan="kernel")(q, q_len, *flat)
    launched = fused_l2max_scan.launches - before
    v_t, d_t = make_dense_search(nb, k=20, scan="torch")(q, q_len, *flat)
    v_k, d_k, v_t, d_t = (x.tolist() for x in (v_k, d_k, v_t, d_t))
    if launched != nb or d_k[0] != 7 or d_t[0] != 7:
        raise AssertionError(f"f32 query: {launched} scan launches for {nb} "
                             f"buckets, first ids {d_k[0]} / {d_t[0]}")
    differ = 0
    for pos, (a, b) in enumerate(zip(d_k, d_t)):
        if not abs(v_k[pos] - v_t[pos]) <= 1e-3 + 2e-4 * abs(v_t[pos]):
            raise AssertionError(f"f32 query: scores {v_k} against {v_t}")
        if a != b:
            near = [abs(v_t[pos] - v_t[o]) for o in (pos - 1, pos + 1)
                    if 0 <= o < len(v_t)]
            if min(near) > 2 * (1e-3 + 2e-4 * abs(v_t[pos])):
                raise AssertionError(f"f32 query: ids {d_k} against {d_t}")
            differ += 1
    out = {"docs": n_docs, "buckets": nb, "k": 20, "scan_launches": launched,
           "first_ids": d_k[:5], "ids_differing": differ,
           "max_score_diff": max(abs(a - b) for a, b in zip(v_k, v_t))}
    emit("index_f32_query", **out)
    return out


def phase_index(dev, layers: int, encode_docs: int, index_docs: int,
                save_dir=None) -> tuple:
    """The path from a corpus to an answered query.  The large index is built
    (and saved under save_dir for the mesh phase) and the scan kernels are
    held against their plain versions first; then the counts are set to 0,
    the path is driven (encode -> indexes -> queries) and the counts are
    read; the plain route's runs and the float32 index's check query come
    after that."""
    from aspire_tpu_torch.models.bert import BertConfig
    torch.cuda.empty_cache()
    big = build_large_index(dev, index_docs, save_dir=save_dir)
    cases = scan_kernel_cases(big, dev)
    reset_counts()
    index_encode(BertConfig(num_hidden_layers=layers), dev, encode_docs)
    finish = index_queries(big, dev)
    launches = read_counts()
    finish()
    index_f32_query(dev)
    return cases, launches


# ----------------------------------------------------------------------- eval
FACET_LABELS = ("background_label", "objective_label", "method_label",
                "result_label")


def eval_vocab(size: int = 30522) -> list:
    """A vocab.txt of BERT-base's size: the five special tokens, punctuation,
    20,000 generated lower-case words of two and three syllables, then '##'
    pieces of one to three syllables."""
    syl = [c + v for c in "bdfgklmnprstvz" for v in "aeiou"]
    two = [a + b for a in syl for b in syl]
    three = [a + b + c for a in syl for b in syl for c in syl]
    words = two + three[:20_000 - len(two)]
    pieces = ["##" + p for p in syl + two + three[len(three) // 2:]]
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ".", ",", "(", ")",
             "-"] + words + pieces
    return vocab[:size]


def random_hf_state_dict(cfg, seed: int) -> dict:
    """BertModel weights under Hugging Face's names (pooler included), from a
    numpy seed: N(0, 0.02), LayerNorm scales 1 + N(0, 0.02)."""
    rng = np.random.default_rng(seed)
    h, f = cfg.hidden_size, cfg.intermediate_size

    def t(*shape, base=0.0):
        return torch.from_numpy(
            (base + rng.standard_normal(shape) * 0.02).astype(np.float32))

    sd = {"embeddings.word_embeddings.weight": t(cfg.vocab_size, h),
          "embeddings.position_embeddings.weight": t(cfg.max_position_embeddings, h),
          "embeddings.token_type_embeddings.weight": t(cfg.type_vocab_size, h),
          "embeddings.LayerNorm.weight": t(h, base=1.0),
          "embeddings.LayerNorm.bias": t(h)}
    for i in range(cfg.num_hidden_layers):
        p = f"encoder.layer.{i}."
        for name, (n_out, n_in) in (("attention.self.query", (h, h)),
                                    ("attention.self.key", (h, h)),
                                    ("attention.self.value", (h, h)),
                                    ("attention.output.dense", (h, h)),
                                    ("intermediate.dense", (f, h)),
                                    ("output.dense", (h, f))):
            sd[p + name + ".weight"] = t(n_out, n_in)
            sd[p + name + ".bias"] = t(n_out)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + name + ".weight"] = t(h, base=1.0)
            sd[p + name + ".bias"] = t(h)
    sd["pooler.dense.weight"] = t(h, h)
    sd["pooler.dense.bias"] = t(h)
    return sd


def write_hf_dir(path: str, cfg, vocab: list, seed: int) -> None:
    """config.json, vocab.txt, tokenizer_config.json and pytorch_model.bin of
    a BERT checkpoint, as `save_pretrained` lays them out."""
    import os
    os.makedirs(path, exist_ok=True)
    with open(f"{path}/config.json", "w") as f:
        json.dump({"architectures": ["BertModel"], "model_type": "bert",
                   "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                   "num_hidden_layers": cfg.num_hidden_layers,
                   "num_attention_heads": cfg.num_attention_heads,
                   "intermediate_size": cfg.intermediate_size,
                   "max_position_embeddings": cfg.max_position_embeddings,
                   "type_vocab_size": cfg.type_vocab_size,
                   "layer_norm_eps": cfg.layer_norm_eps, "hidden_act": "gelu",
                   "hidden_dropout_prob": 0.1,
                   "attention_probs_dropout_prob": 0.1}, f)
    with open(f"{path}/vocab.txt", "w") as f:
        f.write("\n".join(vocab) + "\n")
    with open(f"{path}/tokenizer_config.json", "w") as f:
        json.dump({"tokenizer_class": "BertTokenizer", "do_lower_case": True}, f)
    torch.save(random_hf_state_dict(cfg, seed), f"{path}/pytorch_model.bin")


class TextGen:
    """Sentences of 8 to 25 of the vocab's whole words (now and then with a
    one-syllable piece stuck on, a comma or brackets), from a numpy seed."""

    def __init__(self, vocab: list, seed: int):
        self.rng = np.random.default_rng(seed)
        self.words = [w for w in vocab[10:] if not w.startswith("##")]
        self.suffixes = [w[2:] for w in vocab if w.startswith("##")][:70]

    def word(self) -> str:
        w = self.words[int(self.rng.integers(len(self.words)))]
        if self.rng.random() < 0.1:
            w += self.suffixes[int(self.rng.integers(len(self.suffixes)))]
        return w

    def sentence(self) -> str:
        n = int(self.rng.integers(8, 26))
        ws = [self.word() for _ in range(n)]
        if self.rng.random() < 0.3:
            ws[int(self.rng.integers(1, n))] += ","
        if self.rng.random() < 0.1:
            ws.append("(" + self.word() + ")")
        return (" ".join(ws) + ".").capitalize()

    def abstract(self) -> dict:
        n = int(self.rng.integers(3, 21))
        labels = list(self.rng.choice(FACET_LABELS, n))
        # every query facet has a sentence within the encoded prefix
        labels[:3] = list(self.rng.permutation(
            ["background_label", "method_label", "result_label"]))
        return {"title": " ".join(self.word() for _ in range(
                    int(self.rng.integers(5, 13)))).capitalize(),
                "abstract": [self.sentence() for _ in range(n)],
                "pred_labels": labels}


def write_csfcube(root: str, vocab: list, seed: int, n_docs: int = 2000,
                  pool: int = 120, copies: int = 5) -> dict:
    """A dataset in CSFCube's layout: abstracts-csfcube.jsonl (with
    pred_labels) and test-pid2anns-csfcube-{facet}.json for the real fold
    query ids (16-17 a facet).  The corpus holds the queries, `copies` near
    copies of each (one sentence replaced; relevance 2 or 3) and random
    abstracts; a pool is a query's near copies and random abstracts
    (relevance 0), `pool` candidates in a random order."""
    import os
    from aspire_tpu_torch.evaluation.protocols import load_csfcube_folds
    folds = load_csfcube_folds()
    facet_q = {f: sorted({q.rsplit("_", 1)[0] for fold in folds[f].values()
                          for q in fold}) for f in ("background", "method", "result")}
    qpids = sorted(set().union(*facet_q.values()))
    gen = TextGen(vocab, seed)
    papers = {q: gen.abstract() for q in qpids}
    near = {}
    for q in qpids:
        near[q] = []
        for j in range(copies):
            doc = {**papers[q], "abstract": list(papers[q]["abstract"])}
            k = int(gen.rng.integers(len(doc["abstract"])))
            doc["abstract"][k] = gen.sentence()
            papers[f"{q}-n{j}"] = doc
            near[q].append(f"{q}-n{j}")
    others = [f"r{i}" for i in range(n_docs - len(papers))]
    for pid in others:
        papers[pid] = gen.abstract()
    os.makedirs(root, exist_ok=True)
    with open(f"{root}/abstracts-csfcube.jsonl", "w") as f:
        for pid, p in papers.items():
            f.write(json.dumps({"paper_id": pid, **p}) + "\n")
    for facet, qs in facet_q.items():
        anns = {}
        for q in qs:
            picks = [others[i] for i in gen.rng.choice(len(others), pool - copies,
                                                      replace=False)]
            rels = dict.fromkeys(picks, 0)
            rels.update({c: int(gen.rng.integers(2, 4)) for c in near[q]})
            cands = list(gen.rng.permutation(list(rels)))
            anns[q] = {"cands": cands, "relevance_adju": [rels[c] for c in cands]}
        with open(f"{root}/test-pid2anns-csfcube-{facet}.json", "w") as f:
            json.dump(anns, f)
    return {"docs": len(papers), "queries": {f: len(q) for f, q in facet_q.items()},
            "pool": pool}


def write_triples(path: str, vocab: list, seed: int, n: int) -> None:
    """Co-citation triples: query and positive abstracts, the positive with a
    pre-aligned sentence pair (cc_align)."""
    gen = TextGen(vocab, seed)
    with open(path, "w") as f:
        for _ in range(n):
            q, p = gen.abstract(), gen.abstract()
            f.write(json.dumps({
                "query": {"TITLE": q["title"], "ABSTRACT": q["abstract"]},
                "pos_context": {"TITLE": p["title"], "ABSTRACT": p["abstract"],
                                "cc_align": [int(gen.rng.integers(3)),
                                             int(gen.rng.integers(3))]}}) + "\n")


class EvalSpy:
    """Host-clock time and calls of an evaluation model's encode and
    get_similarities (AspireSimilarityModel's unless `model` names another
    class) while it is entered (each call ends on the host: its results come
    back as numpy arrays), and the summed micro-batch losses of each training
    step."""

    def __init__(self, model=None):
        self.model = model

    def __enter__(self):
        from aspire_tpu_torch.evaluation.models import AspireSimilarityModel
        from aspire_tpu_torch.train.trainer import Trainer
        M = self.model or AspireSimilarityModel
        self.encode_s = self.score_s = 0.0
        self.docs = self.batches = self.queries = 0
        self.step_losses = []
        # (owner, name, the owner's own attribute or None when inherited)
        self._saved = [(M, "encode", M.__dict__.get("encode")),
                       (M, "get_similarities", M.__dict__.get("get_similarities")),
                       (Trainer, "train_step", Trainer.train_step)]
        encode, score, step = M.encode, M.get_similarities, Trainer.train_step
        spy = self

        def timed_encode(model, papers):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = encode(model, papers)
            spy.encode_s += time.perf_counter() - t0
            spy.docs += len(papers)
            spy.batches += 1
            return out

        def timed_score(model, query, cands):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = score(model, query, cands)
            spy.score_s += time.perf_counter() - t0
            spy.queries += 1
            return out

        def logged_step(trainer, state, superbatch, rng):
            losses = step(trainer, state, superbatch, rng)
            spy.step_losses.append([float(x) for x in losses])
            return losses

        M.encode, M.get_similarities = timed_encode, timed_score
        Trainer.train_step = logged_step
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            if fn is None:
                delattr(owner, name)
            else:
                setattr(owner, name, fn)


def _cli(argv: list):
    """aspire_tpu_torch.cli.main in this process, its printing kept apart."""
    import contextlib
    import io
    from aspire_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = cli.main(argv)
    return out, buf.getvalue()


def _scores(path: str) -> dict:
    with open(path) as f:
        return {(q, c): -s for q, rows in json.load(f).items() for c, s in rows}


def _eval_summary(out: dict) -> dict:
    summary = {}
    for key, splits in out.items():
        vals = [v for split in splits.values() for v in split.values()]
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"eval: non-finite aggregates for {key}: {splits}")
        summary[key] = {"map": splits["test"]["mean_av_precision"],
                        "ndcg%20": splits["test"]["ndcg%20"]}
    if set(summary) != {"background", "method", "result", "all"}:
        raise AssertionError(f"eval: aggregates for {sorted(summary)}")
    return summary


# the eval phase's checkpoint depth (BERT-base) and dataset size
EVAL_LAYERS = 12
EVAL_DOCS = 2000


def phase_eval(dev) -> tuple:
    """The user's entry points at BERT-base, through aspire_tpu_torch.cli.main:
    evaluate (kernel and plain OT routes), the plain encoder route on 64
    abstracts, train from a jsonl of triples, and evaluate on the trained run.
    The counts are set to 0 before each run and read after it; those of the
    main path's runs (evaluate with K1, train, evaluate --run-dir) are
    summed, the plain routes' runs are left out."""
    import tempfile
    from aspire_tpu_torch.evaluation.datasets import EvalDataset
    from aspire_tpu_torch.evaluation.models import AspireSimilarityModel
    from aspire_tpu_torch.models.bert import BertConfig
    f32 = torch.float32
    # the shapes the evaluation gives the kernels: 8 abstracts x 512 tokens
    # in f32, 24 sentences, a chunk of 256 pairs of 24 x 24
    cases = {"sinkhorn": [case_sinkhorn(256, "pair", dev, 24, 24)],
             "attention": [case_attention(8, 12, 512, 64, f32, dev)],
             "ffn": [case_ffn(4096, f32, dev)],
             "pool": [case_pool(8, 512, 768, 24, f32, dev)]}
    for name, rows in cases.items():
        emit("kernel_cases", kernel=name, path="eval", cases=rows)
    layers = EVAL_LAYERS
    cfg = BertConfig(vocab_size=30522, num_hidden_layers=layers)
    vocab = eval_vocab(cfg.vocab_size)
    main = dict.fromkeys(read_counts(), 0)

    def add(delta):
        for k, v in delta.items():
            main[k] += v

    def expect(label, got, batches, queries, extra=None):
        want = dict.fromkeys(got, 0)
        want.update(attention=layers * batches,
                    ffn=ffn_launches(f32) * layers * batches,
                    pool=batches, sinkhorn=queries, **(extra or {}))
        if got != want:
            raise AssertionError(f"eval: {label} launched {got}, expected {want}")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_hf_dir(f"{tmp}/hf", cfg, vocab, seed=21)
        data = write_csfcube(f"{tmp}/data", vocab, seed=22, n_docs=EVAL_DOCS)
        setup_s = time.perf_counter() - t0
        common = ["--dataset", "csfcube", "--dataset-dir", f"{tmp}/data",
                  "--device", dev.type]
        # 1. the HF checkpoint, OT by K1 (its final step too)
        reset_counts()
        with EvalSpy() as spy:
            out_k, _ = _cli(["evaluate", *common, "--model", "aspire_compsci",
                             "--weights-dir", f"{tmp}/hf", "--results",
                             f"{tmp}/res_kernel", "--ot-solver", "pallas"])
        got = read_counts()
        expect("evaluate --ot-solver pallas", got, spy.batches, spy.queries)
        add(got)
        kernel_spy, kernel_got = spy, got
        summary = _eval_summary(out_k)
        # near copies of the query (one sentence replaced) must rank first
        if not summary["all"]["map"] >= 0.9:
            raise AssertionError(f"eval: MAP {summary} with near copies as the "
                                 "relevant candidates")
        # 2. the same scoring through the plain loop
        reset_counts()
        with EvalSpy() as plain_spy:
            _cli(["evaluate", *common, "--model", "aspire_compsci",
                  "--weights-dir", f"{tmp}/hf", "--results",
                  f"{tmp}/res_plain", "--ot-solver", "xla"])
        if read_counts()["sinkhorn"]:
            raise AssertionError("eval: --ot-solver xla launched K1")
        gap, n_scores = 0.0, 0
        for facet in ("background", "method", "result"):
            k = _scores(f"{tmp}/res_kernel/scores-{facet}.json")
            p = _scores(f"{tmp}/res_plain/scores-{facet}.json")
            if set(k) != set(p):
                raise AssertionError(f"eval: the routes scored other pairs ({facet})")
            keys = sorted(k)
            kv = torch.tensor([k[x] for x in keys], dtype=torch.float64)
            pv = torch.tensor([p[x] for x in keys], dtype=torch.float64)
            # K1's case tolerance for the scores (sinkhorn sims)
            res = check_close(f"eval scores {facet}", kv, pv, atol=2e-3, rtol=2e-3)
            gap = max(gap, res["max_abs_err"])
            n_scores += len(keys)
        # 3. the plain encoder route on 64 abstracts against the kernel route
        ds = EvalDataset("csfcube", f"{tmp}/data")
        papers = [ds.get(pid) for pid, _ in list(ds)[:64]]
        routes = {}
        for impl in ("auto", "naive"):
            m = AspireSimilarityModel.from_hf_dir(
                impl, f"{tmp}/hf", device=dev, attention_impl=impl,
                ffn_impl=impl, pool_impl=impl)
            reset_counts()
            routes[impl] = [r for i in range(0, 64, 8)
                            for r in m.encode(papers[i:i + 8])]
            routes[impl + "_launches"] = read_counts()
            del m
        if any(routes["naive_launches"].values()):
            raise AssertionError(f"eval: the plain route launched "
                                 f"{routes['naive_launches']}")
        enc_err = {"max_abs_err": 0.0}
        for a, b in zip(routes["auto"], routes["naive"]):
            if a.shape != b.shape:
                raise AssertionError(f"eval: encodings {a.shape} against {b.shape}")
            res = check_close("eval encode, kernel against plain route",
                              torch.from_numpy(a), torch.from_numpy(b),
                              atol=_tol(f32))
            enc_err = max(enc_err, res, key=lambda r: r["max_abs_err"])
        torch.cuda.empty_cache()
        # 4. train from a jsonl of triples, the encoder from the HF directory
        write_triples(f"{tmp}/train.jsonl", vocab, seed=23, n=12)
        with open(f"{tmp}/cfg.json", "w") as f:
            json.dump({"model_name": "sbalisentbienc",
                       "score_aggregation": "l2wasserstein",
                       "sent_sm_temp": 5000.0, "sent_loss_prop": 1.0,
                       "sentsup_loss_prop": 1.0, "max_sents": 24,
                       "batch_size": 3, "accumulated_batch_size": 6,
                       "train_size": 12, "num_epochs": 1, "update_rule": "adam",
                       "learning_rate": 2e-5, "lr_decay_method": "warmuplin",
                       "num_warmup_steps": 2, "es_check_every": 10_000,
                       "base-pt-layer": f"{tmp}/hf"}, f)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with EvalSpy() as train_spy:
            trainer, _ = _cli(["train", "--config", f"{tmp}/cfg.json", "--train",
                               f"{tmp}/train.jsonl", "--out", f"{tmp}/run",
                               "--init-hf-dir", f"{tmp}/hf", "--seq-len", "512",
                               "--device", dev.type])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        got = read_counts()
        steps = len(train_spy.step_losses)
        # per step: two wide encodes (query, positive), a bf16 backward of
        # three launches a layer each, 1 + 2 * layers dropout sites a side
        # forward and backward, two K1 annealing loops (positive, negative)
        want = dict.fromkeys(got, 0)
        want.update(attention_dropout=steps * 2 * layers,
                    attention_bwd=steps * 2 * 3 * layers,
                    dropout=steps * 2 * 2 * (1 + 2 * layers), sinkhorn=steps * 2)
        losses = [sum(x) for x in train_spy.step_losses]
        if steps != 2 or got != want or not all(map(math.isfinite, losses)):
            raise AssertionError(f"eval: train took {steps} steps, launched "
                                 f"{got} (expected {want}), losses {losses}")
        add(got)
        del trainer
        torch.cuda.empty_cache()
        # 5. evaluate the trained run, OT by K1
        reset_counts()
        with EvalSpy() as spy5:
            out_t, _ = _cli(["evaluate", *common, "--model", "otaspire",
                             "--run-dir", f"{tmp}/run", "--tokenizer", f"{tmp}/hf",
                             "--results", f"{tmp}/res_trained", "--ot-solver",
                             "pallas"])
        got = read_counts()
        expect("evaluate --run-dir", got, spy5.batches, spy5.queries)
        add(got)
        summary_trained = _eval_summary(out_t)
    spy = kernel_spy
    emit("eval", model="aspire_compsci (random BERT-base weights, seed 21)",
         layers=layers, dtype="float32", seq_len=512, max_sents=24,
         batch=8, dataset=data, setup_s=setup_s,
         docs_encoded=spy.docs, encode_batches=spy.batches,
         docs_per_s=spy.docs / spy.encode_s, encode_s=spy.encode_s,
         queries=spy.queries, score_ms_per_query=spy.score_s / spy.queries * 1e3,
         score_ms_per_query_plain_loop=plain_spy.score_s / plain_spy.queries * 1e3,
         launches_per_query={"sinkhorn": kernel_got["sinkhorn"] / spy.queries},
         launches_per_batch={k: kernel_got[k] / spy.batches
                             for k in ("attention", "ffn", "pool")},
         metrics=summary, score_gap_kernel_vs_plain=gap, scores_compared=n_scores,
         score_tolerance={"atol": 2e-3, "rtol": 2e-3},
         encode_kernel_vs_plain={"docs": 64, "max_abs_err": enc_err["max_abs_err"],
                                 "atol": _tol(f32)},
         train={"model": "sbalisentbienc l2wasserstein", "dtype": "bfloat16",
                "superbatch": [2, 3, 512], "steps": steps,
                "step_losses": losses, "seconds_with_checkpoints": train_s},
         trained_metrics=summary_trained,
         trained_docs_per_s=spy5.docs / spy5.encode_s,
         launches=main)
    return cases, main


# ---------------------------------------------------------------------- chain
CHAIN_STEPS = 4          # optimizer steps of each of the chain's two trainings
CHAIN_PROCESSES = 4      # the gorc pipeline's worker processes (spawn)


class AlignerSpy:
    """Host-clock time, sentences and shapes of each sentence-encoder call
    (TrainedSentSimilarityModel.encode) while entered: the aligner's encodes.
    Each call ends on the host (its reps come back as numpy arrays)."""

    def __enter__(self):
        from aspire_tpu_torch.evaluation import models
        self.owner = models.TrainedSentSimilarityModel
        self.saved = self.owner.encode
        self.calls, self.seconds = [], 0.0
        encode, spy = self.saved, self

        def timed(model, papers):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = encode(model, papers)
            spy.seconds += time.perf_counter() - t0
            spy.calls.append(sum(len(p["ABSTRACT"]) for p in papers))
            return out

        self.owner.encode = timed
        return self

    def __exit__(self, *exc):
        self.owner.encode = self.saved


def _load_chain_script():
    """scripts/torch_e2e_chain.py: the corpus synthesiser and the stages."""
    import importlib.util
    path = REPO / "scripts" / "torch_e2e_chain.py"
    spec = importlib.util.spec_from_file_location("torch_e2e_chain", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jsonl(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def _argmax_margin(m: np.ndarray) -> tuple:
    """(row, column) of the largest entry and its lead over the next."""
    flat = np.sort(m.reshape(-1))
    lead = float(flat[-1] - flat[-2]) if flat.size > 1 else math.inf
    return np.unravel_index(m.argmax(), m.shape), lead


def check_alignments(paths, reps: dict, margin: float) -> dict:
    """cc_align / abs_align of each positive, as generate_examples_cocitabs
    computes them, from `reps` (sentence -> unit vector); an alignment is
    compared where its argmax leads the runner-up by more than `margin`."""
    compared = skipped = 0
    for path in paths:
        for ex in _jsonl(path):
            pos = ex["pos_context"]
            q = np.stack([reps[s] for s in ex["query"]["ABSTRACT"]])
            p = np.stack([reps[s] for s in pos["ABSTRACT"]])
            c = np.stack([reps[s] for s in ex["citing_contexts"]])
            (qi, _), lead_q = _argmax_margin(q @ c.T)
            (pi, _), lead_p = _argmax_margin(p @ c.T)
            (ai, aj), lead_a = _argmax_margin(q @ p.T)
            for got, want, lead in ((pos["cc_align"][0], qi, lead_q),
                                    (pos["cc_align"][1], pi, lead_p),
                                    (pos["abs_align"], [ai, aj], lead_a)):
                if lead <= margin:
                    skipped += 1
                    continue
                compared += 1
                if np.any(np.asarray(got) != np.asarray(want)):
                    raise AssertionError(
                        f"chain: {path}: alignment {got} where the plain route "
                        f"gives {want} (lead {lead})")
    if not compared:
        raise AssertionError("chain: no alignment led by more than the margin")
    return {"compared": compared, "skipped_within_margin": skipped,
            "margin": margin}


def phase_chain(dev) -> tuple:
    """The two-model supervision chain through aspire_tpu_torch.cli.main, at
    BERT-base width: gorc -> cosentbert -> aligned triples -> sbalisentbienc
    -> build-index -> rank.  The counts are set to 0 before each stage and
    read after it; their sum is the path's.  Then the aligner's kernel route
    against its plain route, and K2 / K3 in f32 at the aligner's shapes."""
    import os
    import tempfile
    from aspire_tpu_torch.data.align import trained_sent_aligner
    f32 = torch.float32
    chain = _load_chain_script()
    # the pilot corpus at BERT-base width: 12 layers, hidden 768, 64 tokens
    # a sentence, 128 a document
    sc = dict(chain.SCALES["pilot"], tiny=False, seq_len=128, lr=1e-4)
    layers = 12
    main = dict.fromkeys(read_counts(), 0)
    stages, stage_counts = {}, {}

    def stage(name, argv):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out, _ = _cli(argv)
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        got = read_counts()
        stage_counts[name] = {k: v for k, v in got.items() if v}
        for k, v in got.items():
            main[k] += v
        return out, got

    def require(name, got, kernels):
        idle = [k for k in kernels if got[k] < 1]
        if idle:
            raise AssertionError(f"chain: stage {name} launched no {idle} "
                                 f"({got})")

    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        t0 = time.perf_counter()
        data = chain.write_data(root, sc)
        stages["write_data"] = time.perf_counter() - t0
        # 1. the gorc pipeline, in this process (a spawn pool of 4) ...
        summary, got = stage("1_preprocess_gorc",
                             chain.gorc_argv(root, CHAIN_PROCESSES, dev.type))
        if any(got.values()):
            raise AssertionError(f"chain: preprocess gorc launched {got}")
        tri = root / "triples"
        outputs = ["train-cocitabs.jsonl", "dev-cocitabs.jsonl",
                   "train-coppsent.jsonl", "dev-coppsent.jsonl",
                   "gorc-summary.json", "cocitpids2contexts-all.pickle"]
        for name in outputs:
            if not (tri / name).stat().st_size:
                raise AssertionError(f"chain: preprocess gorc wrote no {name}")
        # ... and once as a user runs it: the same files
        sub_root = root / "sub"
        sub_argv = chain.gorc_argv(root, CHAIN_PROCESSES, dev.type)
        sub_argv[sub_argv.index("--out-path") + 1] = str(sub_root)
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "aspire_tpu_torch", *sub_argv],
                       check=True, cwd=tmp, capture_output=True,
                       env={**os.environ, "PYTHONPATH": str(REPO)})
        stages["1_preprocess_gorc_subprocess"] = time.perf_counter() - t0
        partials = sorted(p.name for p in tri.glob("*-*.jsonl"))
        for name in outputs[:-1] + partials:
            if (tri / name).read_bytes() != (sub_root / name).read_bytes():
                raise AssertionError(f"chain: {name} differs between the "
                                     "in-process and the subprocess run")
        chain.write_configs(root, sc, summary["sent_examples"],
                            summary["examples"], CHAIN_STEPS)
        # 2. the sentence encoder (cosentbert, bf16 training)
        _, got = stage("2_train_cosentbert", chain.sentenc_argv(root, sc, dev.type))
        require("2", got, ("attention_dropout", "attention_bwd", "dropout"))
        # 3. the aligned triples, the aligner on the card in f32
        with AlignerSpy() as spy:
            _, got = stage("3_preprocess_regen_examples",
                           chain.align_argv(root, dev.type))
        calls = len(spy.calls)
        want = {"attention": layers * calls, "ffn": ffn_launches(f32) * layers * calls}
        if not calls or any(got[k] != v for k, v in want.items()):
            raise AssertionError(f"chain: the aligner's {calls} calls launched "
                                 f"{got}, expected {want}")
        enc = root / "triples_enc"
        examples = [enc / "train-cocitabsalign.jsonl", enc / "dev-cocitabsalign.jsonl"]
        sents = {}
        for path in examples:
            for ex in _jsonl(path):
                sides = [ex["pos_context"]] + ([ex["neg_context"]]
                                               if "neg_context" in ex else [])
                for side in sides:
                    if not {"cc_align", "abs_align"} <= set(side):
                        raise AssertionError(f"chain: {path.name}: an example "
                                             "without cc_align / abs_align")
                for s in (ex["query"]["ABSTRACT"] + ex["pos_context"]["ABSTRACT"]
                          + ex["citing_contexts"]):
                    sents[s] = None
        sents = list(sents)
        # the same aligner through the plain route (naive attention and FFN)
        aligners = {}
        for route in ("kernel", "plain"):
            aligner = trained_sent_aligner(str(root / "run-sentenc"),
                                           str(root / "tokenizer"), device=dev)
            if route == "plain":
                for m in aligner.model.bert.modules():
                    for attr in ("attention_impl", "ffn_impl"):
                        if hasattr(m, attr):
                            setattr(m, attr, "naive")
            reset_counts()
            aligners[route] = aligner(sents)
            aligners[route + "_launches"] = {k: v for k, v in read_counts().items() if v}
        if aligners["plain_launches"] or not aligners["kernel_launches"]:
            raise AssertionError(f"chain: aligner launches {aligners}")
        align_err = check_close("chain aligner, kernel against plain route",
                                torch.from_numpy(aligners["kernel"]),
                                torch.from_numpy(aligners["plain"]),
                                atol=_tol(f32))
        alignments = check_alignments(
            examples, dict(zip(sents, aligners["plain"])), margin=1e-4)
        # 4. the doc model on the aligned triples (bf16 training, OT loss)
        _, got = stage("4_train_sbalisentbienc", chain.train_argv(root, sc, dev.type))
        require("4", got, ("attention_dropout", "attention_bwd", "dropout",
                           "sinkhorn"))
        losses = {}
        for run in ("run-sentenc", "run"):
            losses[run] = chain.train_losses(root / run)
            if not losses[run] or not all(math.isfinite(v) for _, v in losses[run]):
                raise AssertionError(f"chain: {run} losses {losses[run]}")
        # 5. index the held-out corpus, rank the pools with an OT rerank
        _, got = stage("5_build_index", chain.index_argv(root, dev.type))
        require("5 build-index", got, ("attention", "ffn", "pool"))
        _, got = stage("5_rank", chain.rank_argv(root, sc, dev.type))
        require("5 rank", got, ("sinkhorn",))
        ranking = chain.score_ranking(root)
        for v in list(ranking["map"].values()) + list(ranking["ndcg%20"].values()):
            if not math.isfinite(v):
                raise AssertionError(f"chain: ranking {ranking}")
    # K2 and K3 in f32 at the aligner's shapes: its median and largest call
    # here, and a call of 16 sentences (a co-citation's ten contexts and an
    # abstract, as a full-size corpus gives them)
    rows = sorted(spy.calls)
    shapes = sorted({max(2, rows[len(rows) // 2]), max(2, rows[-1]), 16})
    t = 64                                  # sentences pad to 64 tokens
    cases = {"attention": [case_attention(n, 12, t, 64, f32, dev) for n in shapes],
             "ffn": [case_ffn(n * t, f32, dev) for n in shapes]}
    for name, kernel_rows in cases.items():
        emit("kernel_cases", kernel=name, path="chain", cases=kernel_rows)
    sents_per_s = sum(spy.calls) / spy.seconds
    emit("chain", card=CARD, scale="pilot", layers=layers, hidden=768,
         seq_len={"sentence": 64, "document": sc["seq_len"]},
         steps_each_training=CHAIN_STEPS, processes=CHAIN_PROCESSES,
         data=data, gorc=summary, stage_s=stages, stage_launches=stage_counts,
         aligner={"calls": calls, "sentences": sum(spy.calls),
                  "sentences_a_call": {"median": rows[len(rows) // 2],
                                       "max": rows[-1], "min": rows[0]},
                  "encode_s": spy.seconds, "sentences_per_s": sents_per_s,
                  "launches_a_call": {k: got_a / calls for k, got_a in
                                      stage_counts["3_preprocess_regen_examples"].items()},
                  "kernel_vs_plain": {"sentences": len(sents),
                                      "max_abs_err": align_err["max_abs_err"],
                                      "atol": _tol(f32), **alignments}},
         losses=losses, ranking=ranking, launches=main)
    return cases, main


# ------------------------------------------------------------------- families
EXAMPLES = ("consent", "multimatch", "bienc")
NUMBER = re.compile(r"-?\d+\.\d*(?:e-?\d+)?")


def parse_example(text: str) -> dict:
    """An example's printed lines: shape lines and the best pair as text, the
    reps-derived score, the OT similarity and the transport plan as numbers."""
    out = {"lines": [ln for ln in text.splitlines()
                     if ln.startswith(("doc CLS reps:", "CLS reps:", "best-matching"))]}
    for key, prefix in (("score", "tsAspire similarity:"),
                        ("score", "bi-encoder similarity (-L2):"),
                        ("ot", "otAspire similarity:")):
        if prefix in text:
            out[key] = float(text.split(prefix)[1].split()[0])
    if "(query sents x cand sents):" in text:
        out["plan"] = [float(x) for x in NUMBER.findall(
            text.split("(query sents x cand sents):")[1])]
    return out


def run_example(name: str, argv: list) -> str:
    """examples/ex_{name}_torch.py's main in this process; its stdout."""
    import contextlib
    import importlib
    import io
    sys.path.insert(0, str(REPO / "examples"))
    try:
        module = importlib.import_module(f"ex_{name}_torch")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            module.main(argv)
    finally:
        sys.path.remove(str(REPO / "examples"))
    return buf.getvalue()


NOTEBOOK = "examples/demo-contextualsentence-multim_torch.ipynb"


def run_notebook(device: str) -> str:
    """The demo notebook twin's code cells, one after another in this
    process, with its first cell's DEVICE set to `device`; their stdout."""
    import contextlib
    import io
    cells = json.loads((REPO / NOTEBOOK).read_text())["cells"]
    code = ["".join(c["source"]) for c in cells if c["cell_type"] == "code"]
    if 'DEVICE = "cuda"' not in code[0]:
        raise AssertionError(f"{NOTEBOOK}: no DEVICE = \"cuda\" in the first cell")
    code[0] = code[0].replace('DEVICE = "cuda"', f'DEVICE = "{device}"')
    namespace, buf = {"__name__": "__main__"}, io.StringIO()
    with contextlib.redirect_stdout(buf):
        for src in code:
            exec(compile(src, NOTEBOOK, "exec"), namespace)
    return buf.getvalue()


def parse_notebook(text: str) -> dict:
    """The notebook's printed shapes, OT and tsAspire similarities and the
    transport plan (rounded to 4 places)."""
    ts_prefix = "tsAspire (single best match) similarity:"
    after = text.split(ts_prefix)[1]
    return {"lines": [ln for ln in text.splitlines() if ln.startswith("CLS reps:")],
            "ot": float(text.split("otAspire similarity:")[1].split()[0]),
            "score": float(after.split()[0]),
            "plan": [float(x) for x in NUMBER.findall(
                after.split("\n", 1)[1].split("plan[")[0])]}


def phase_examples(dev) -> tuple:
    """Each example as a user runs it (a subprocess on the card, the three
    side by side) against the same script's --device cpu run: lines equal,
    reps-derived scores within 1e-4, the OT similarity and the plan within
    1e-3 (the plan's printed entries are rounded to 4 places).  Then each
    once more in this process on the card, with the counts set to 0 before
    it and read after it.  Last the demo notebook's twin, its code cells in
    this process on the card (counted) and with DEVICE = "cpu", held alike."""
    import os
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, f"ex_{name}_torch.py"], cwd=REPO / "examples", env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in EXAMPLES}
    results, launches = {}, {}
    total = dict.fromkeys(read_counts(), 0)
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        if proc.returncode:
            raise AssertionError(f"families: ex_{name}_torch.py exited "
                                 f"{proc.returncode}: {stderr[-2000:]}")
        card, cpu = parse_example(stdout), parse_example(
            run_example(name, ["--device", "cpu"]))
        if card["lines"] != cpu["lines"] or set(card) != set(cpu):
            raise AssertionError(f"families: ex_{name}_torch.py printed {card} "
                                 f"on the card, {cpu} on the CPU")
        errs = {}
        for key, atol in (("score", 1e-4), ("ot", 1e-3), ("plan", 1e-3 + 1e-4)):
            if key in card:
                errs[key] = check_close(
                    f"ex_{name}_torch {key}, card against CPU",
                    torch.tensor(card[key], dtype=torch.float64),
                    torch.tensor(cpu[key], dtype=torch.float64), atol=atol)["max_abs_err"]
        results[name] = {"subprocess_s": time.perf_counter() - t0, **card,
                         "max_abs_err_vs_cpu": errs}
    for name in EXAMPLES:
        torch.cuda.synchronize()
        reset_counts()
        t1 = time.perf_counter()
        run_example(name, [])
        torch.cuda.synchronize()
        results[name]["in_process_s"] = time.perf_counter() - t1
        got = read_counts()
        launches[name] = {k: v for k, v in got.items() if v}
        for k, v in got.items():
            total[k] += v
    torch.cuda.synchronize()
    reset_counts()
    t1 = time.perf_counter()
    card = parse_notebook(run_notebook("cuda"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    got = read_counts()
    launches["notebook"] = {k: v for k, v in got.items() if v}
    for k, v in got.items():
        total[k] += v
    cpu = parse_notebook(run_notebook("cpu"))
    if card["lines"] != cpu["lines"] or len(card["plan"]) != len(cpu["plan"]) \
            or not card["plan"]:
        raise AssertionError(f"families: {NOTEBOOK} printed {card} on the card, "
                             f"{cpu} on the CPU")
    errs = {key: check_close(f"{NOTEBOOK} {key}, card against CPU",
                             torch.tensor(card[key], dtype=torch.float64),
                             torch.tensor(cpu[key], dtype=torch.float64),
                             atol=atol)["max_abs_err"]
            for key, atol in (("score", 1e-4), ("ot", 1e-3), ("plan", 1e-3 + 1e-4))}
    results["notebook"] = {"in_process_s": seconds, **card, "max_abs_err_vs_cpu": errs}
    # BertConfig.tiny(): 2 layers, f32 (three K3 launches a call), one pool
    # a ConSent encode, one K1 loop a distance
    want = {"consent": {"attention": 2, "ffn": 6, "pool": 1},
            "multimatch": {"attention": 2, "ffn": 6, "pool": 1, "sinkhorn": 1},
            "bienc": {"attention": 2, "ffn": 6},
            "notebook": {"attention": 2, "ffn": 6, "pool": 1, "sinkhorn": 1}}
    if launches != want:
        raise AssertionError(f"families: the examples launched {launches}, "
                             f"expected {want}")
    return results, launches, total


def random_mpnet_state_dict(cfg, seed: int) -> dict:
    """MPNetModel weights under Hugging Face's names (pooler included), from
    a numpy seed: N(0, 0.02), LayerNorm scales 1 + N(0, 0.02)."""
    rng = np.random.default_rng(seed)
    h, f = cfg.hidden_size, cfg.intermediate_size

    def t(*shape, base=0.0):
        return torch.from_numpy(
            (base + rng.standard_normal(shape) * 0.02).astype(np.float32))

    sd = {"embeddings.word_embeddings.weight": t(cfg.vocab_size, h),
          "embeddings.position_embeddings.weight": t(cfg.max_position_embeddings, h),
          "embeddings.LayerNorm.weight": t(h, base=1.0),
          "embeddings.LayerNorm.bias": t(h),
          "encoder.relative_attention_bias.weight": t(
              cfg.relative_attention_num_buckets, cfg.num_attention_heads)}
    for i in range(cfg.num_hidden_layers):
        p = f"encoder.layer.{i}."
        for name, (n_out, n_in) in (("attention.attn.q", (h, h)),
                                    ("attention.attn.k", (h, h)),
                                    ("attention.attn.v", (h, h)),
                                    ("attention.attn.o", (h, h)),
                                    ("intermediate.dense", (f, h)),
                                    ("output.dense", (h, f))):
            sd[p + name + ".weight"] = t(n_out, n_in)
            sd[p + name + ".bias"] = t(n_out)
        for name in ("attention.LayerNorm", "output.LayerNorm"):
            sd[p + name + ".weight"] = t(h, base=1.0)
            sd[p + name + ".bias"] = t(h)
    sd["pooler.dense.weight"] = t(h, h)
    sd["pooler.dense.bias"] = t(h)
    return sd


def bpe_files(texts: list, size: int) -> tuple:
    """A byte-level BPE of `size` entries: <s> <pad> </s> <unk>, the 256 byte
    symbols, merges that spell the texts' words, most frequent first (each
    word's byte symbols joined left to right), filler entries, <mask> last.
    Returns (vocab dict, merges)."""
    import collections
    from aspire_tpu_torch.text.bpe import bytes_to_unicode, pre_tokenize
    table = bytes_to_unicode()
    vocab = {tok: i for i, tok in enumerate(("<s>", "<pad>", "</s>", "<unk>"))}
    for ch in table.values():
        vocab[ch] = len(vocab)
    merges = []
    words = collections.Counter(w for text in texts for w in pre_tokenize(text))
    for word, _ in words.most_common():
        chars = "".join(table[b] for b in word.encode("utf-8"))
        for i in range(2, len(chars) + 1):
            if len(vocab) == size - 1:
                break
            if chars[:i] not in vocab:
                merges.append((chars[:i - 1], chars[i - 1]))
                vocab[chars[:i]] = len(vocab)
    while len(vocab) < size - 1:
        vocab[f"<filler{len(vocab)}>"] = len(vocab)
    vocab["<mask>"] = size - 1
    return vocab, merges


FAMILY_CONFIG = {"num_hidden_layers": 12, "hidden_size": 768,
                 "num_attention_heads": 12, "intermediate_size": 3072,
                 "max_position_embeddings": 514, "layer_norm_eps": 1e-5,
                 "hidden_act": "gelu", "hidden_dropout_prob": 0.1,
                 "attention_probs_dropout_prob": 0.1, "pad_token_id": 1,
                 "bos_token_id": 0, "eos_token_id": 2}


def write_roberta_dir(path: str, texts: list, seed: int) -> None:
    """nli-roberta-base-v2's config at random weights ("roberta."-prefixed
    names), a byte-level BPE of 50,265 entries learned from `texts`."""
    import os
    from aspire_tpu_torch.models.bert import BertConfig
    os.makedirs(path, exist_ok=True)
    vocab, merges = bpe_files(texts, 50265)
    cfg = BertConfig(vocab_size=50265, type_vocab_size=1, layer_norm_eps=1e-5,
                     max_position_embeddings=514)
    with open(f"{path}/config.json", "w") as f:
        json.dump({"architectures": ["RobertaModel"], "model_type": "roberta",
                   "vocab_size": 50265, "type_vocab_size": 1, **FAMILY_CONFIG}, f)
    with open(f"{path}/vocab.json", "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(f"{path}/merges.txt", "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    with open(f"{path}/tokenizer_config.json", "w") as f:
        json.dump({"tokenizer_class": "RobertaTokenizer", "add_prefix_space": False,
                   "bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
                   "sep_token": "</s>", "cls_token": "<s>", "pad_token": "<pad>",
                   "mask_token": "<mask>"}, f)
    torch.save({"roberta." + k: v for k, v in random_hf_state_dict(cfg, seed).items()},
               f"{path}/pytorch_model.bin")


def write_mpnet_dir(path: str, words: list, seed: int) -> None:
    """all-mpnet-base-v2's config at random weights, a WordPiece vocab of
    30,527 entries (<s> <pad> </s> <unk>, `words`, <mask>) and a
    tokenizer_config.json with its special tokens as AddedToken dicts."""
    import os
    from aspire_tpu_torch.models.mpnet import MPNetConfig
    os.makedirs(path, exist_ok=True)
    vocab = ["<s>", "<pad>", "</s>", "<unk>"] + words + ["<mask>"]
    raw = {"architectures": ["MPNetModel"], "model_type": "mpnet",
           "vocab_size": len(vocab), "relative_attention_num_buckets": 32,
           **FAMILY_CONFIG}
    with open(f"{path}/config.json", "w") as f:
        json.dump(raw, f)
    with open(f"{path}/vocab.txt", "w") as f:
        f.write("\n".join(vocab) + "\n")
    added = lambda tok: {"content": tok, "lstrip": tok == "<mask>",  # noqa: E731
                         "normalized": False, "rstrip": False,
                         "single_word": False, "__type": "AddedToken"}
    with open(f"{path}/tokenizer_config.json", "w") as f:
        json.dump({"tokenizer_class": "MPNetTokenizer", "do_lower_case": True,
                   **{k: added(v) for k, v in (
                       ("bos_token", "<s>"), ("eos_token", "</s>"),
                       ("cls_token", "<s>"), ("sep_token", "</s>"),
                       ("pad_token", "<pad>"), ("unk_token", "[UNK]"),
                       ("mask_token", "<mask>"))}}, f)
    torch.save(random_mpnet_state_dict(MPNetConfig.from_hf(raw), seed),
               f"{path}/pytorch_model.bin")


FAMILIES = {"sbrobertanli": "roberta", "sbmpnet1B": "mpnet"}
FAMILY_FACET = "background"


def phase_families(dev) -> tuple:
    """The examples (phase_examples), then `evaluate` with sbrobertanli and
    sbmpnet1B through aspire_tpu_torch.cli.main on one facet of the eval
    phase's CSFCube-layout dataset, each from a random-weight directory at
    its published widths; the counts set to 0 before each run and read after
    it.  Then each family's kernel route against its plain route on 64
    abstracts, and K2 / K3 in f32 at the families' sentence shapes."""
    import tempfile
    from aspire_tpu_torch.evaluation.datasets import EvalDataset
    from aspire_tpu_torch.evaluation.models import SbertSimilarityModel as Sbert
    f32 = torch.float32
    examples, example_launches, main = phase_examples(dev)
    emit("examples", card=CARD, examples=examples, launches=example_launches)
    layers = FAMILY_CONFIG["num_hidden_layers"]
    vocab = eval_vocab(30522)
    out, shapes = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = write_csfcube(f"{tmp}/data", vocab, seed=22, n_docs=EVAL_DOCS)
        ds = EvalDataset("csfcube", f"{tmp}/data")
        papers = [ds.get(pid) for pid, _ in list(ds)[:64]]
        texts = [s for p in papers for s in [p["TITLE"]] + p["ABSTRACT"]]
        write_roberta_dir(f"{tmp}/roberta", texts, seed=31)
        write_mpnet_dir(f"{tmp}/mpnet", vocab, seed=32)
        setup_s = time.perf_counter() - t0
        for name, family in FAMILIES.items():
            rows = shapes[name] = []
            pool = Sbert._mean_pool

            def recorded(model, ids, attn, pool=pool, rows=rows):
                rows.append(tuple(ids.shape))
                return pool(model, ids, attn)

            Sbert._mean_pool = recorded
            torch.cuda.synchronize()
            reset_counts()
            try:
                with EvalSpy(Sbert) as spy:
                    agg, _ = _cli(["evaluate", "--model", name, "--weights-dir",
                                   f"{tmp}/{family}", "--dataset", "csfcube",
                                   "--dataset-dir", f"{tmp}/data", "--facet",
                                   FAMILY_FACET, "--results", f"{tmp}/res_{name}",
                                   "--device", dev.type])
            finally:
                Sbert._mean_pool = pool
            got = read_counts()
            want = dict.fromkeys(got, 0)
            want["ffn"] = ffn_launches(f32) * layers * spy.batches
            if family == "roberta":           # MPNet's attention is its own
                want["attention"] = layers * spy.batches
            if got != want:
                raise AssertionError(f"families: {name} launched {got}, "
                                     f"expected {want}")
            for k, v in got.items():
                main[k] += v
            vals = [v for split in agg[FAMILY_FACET].values() for v in split.values()]
            if not all(math.isfinite(v) for v in vals):
                raise AssertionError(f"families: {name} aggregates {agg}")
            # the kernel route against the plain route on 64 abstracts
            routes = {}
            for impl in ("auto", "naive"):
                m = Sbert(name, f"{tmp}/{family}", device=dev,
                          attention_impl=impl, ffn_impl=impl)
                reset_counts()
                routes[impl] = [r for i in range(0, 64, 8)
                                for r in m.encode(papers[i:i + 8])]
                routes[impl + "_launches"] = {k: v for k, v in read_counts().items() if v}
                del m
            if routes["naive_launches"]:
                raise AssertionError(f"families: the plain route of {name} "
                                     f"launched {routes['naive_launches']}")
            err = check_close(f"families {name} encode, kernel against plain route",
                              torch.from_numpy(np.concatenate(routes["auto"])),
                              torch.from_numpy(np.concatenate(routes["naive"])),
                              atol=_tol(f32))
            rows.sort()
            out[name] = {
                "family": family, "docs_encoded": spy.docs,
                "encode_batches": spy.batches, "docs_per_s": spy.docs / spy.encode_s,
                "encode_s": spy.encode_s, "queries": spy.queries,
                "score_ms_per_query": spy.score_s / spy.queries * 1e3,
                "metrics": {"map": agg[FAMILY_FACET]["test"]["mean_av_precision"],
                            "ndcg%20": agg[FAMILY_FACET]["test"]["ndcg%20"]},
                "launches": {k: v for k, v in got.items() if v},
                "launches_per_batch": {k: v / spy.batches for k, v in got.items() if v},
                "sentence_rows": {"median": rows[len(rows) // 2], "max": rows[-1]},
                "kernel_vs_plain": {"docs": 64, "max_abs_err": err["max_abs_err"],
                                    "atol": _tol(f32)}}
            torch.cuda.empty_cache()
    # K2 and K3 in f32 at a median batch's shape of each family (sentences x
    # tokens): K2 runs RoBERTa's, K3 both
    rob = out["sbrobertanli"]["sentence_rows"]["median"]
    mpn = out["sbmpnet1B"]["sentence_rows"]["median"]
    cases = {"attention": [case_attention(rob[0], 12, rob[1], 64, f32, dev)],
             "ffn": [case_ffn(rob[0] * rob[1], f32, dev),
                     case_ffn(mpn[0] * mpn[1], f32, dev)]}
    for name, kernel_rows in cases.items():
        emit("kernel_cases", kernel=name, path="families", cases=kernel_rows)
    emit("families", card=CARD, dataset=data, facet=FAMILY_FACET, layers=layers,
         hidden=768, dtype="float32", setup_s=setup_s, models=out, launches=main)
    return cases, main


# --------------------------------------------------------------------- checks
INT8_DOCS, INT8_QUERIES = 4000, 50


def _load_script(path: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(pathlib.Path(path).stem,
                                                  REPO / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_int8_corpus(root: pathlib.Path, n_docs: int, seed: int = 0) -> None:
    """Abstracts of the chain phase's synthesiser at its full scale (50
    topics, 4-6 sentences of 6-10 words) and a vocab of their words."""
    import random
    chain = _load_chain_script()
    sc = chain.SCALES["full"]
    rng = random.Random(seed)
    lex = chain.make_lexicon(sc["topics"])
    chain.write_tokenizer(root / "tokenizer", lex)
    with open(root / "abstracts.jsonl", "w") as f:
        for i in range(n_docs):
            t = i % sc["topics"]
            f.write(json.dumps({
                "paper_id": f"d{i}", "title": f"paper about {chain.topic_word(t, 0)} methods",
                "abstract": chain.make_abstract_sents(rng, lex[t], sc)}) + "\n")


def phase_checks(dev) -> tuple:
    """benchmarks/torch_convergence_check.py at full size (160 steps,
    asserted), then scripts/torch_int8_validation.py --random-bert on 4,000 +
    50 abstracts (reported, not gated); the counts set to 0 before each and
    read after it."""
    import tempfile
    layers = 12
    main = dict.fromkeys(read_counts(), 0)
    torch.cuda.synchronize()
    reset_counts()
    conv = _load_script("benchmarks/torch_convergence_check.py").main([])
    got = read_counts()
    steps = conv["steps"]
    # a step: two wide encodes (query, positive), a bf16 backward of three
    # launches a layer each, 1 + 2 * layers dropout sites a side forward and
    # backward, two K1 annealing loops
    want = dict.fromkeys(got, 0)
    want.update(attention_dropout=steps * 2 * layers,
                attention_bwd=steps * 2 * 3 * layers,
                dropout=steps * 2 * 2 * (1 + 2 * layers), sinkhorn=steps * 2)
    if got != want:
        raise AssertionError(f"checks: the convergence check launched {got}, "
                             f"expected {want}")
    for k, v in got.items():
        main[k] += v
    emit("convergence", card=CARD, **conv, ms_per_step=conv["seconds"] / steps * 1e3,
         launches={k: v for k, v in got.items() if v})
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        write_int8_corpus(root, INT8_DOCS + INT8_QUERIES)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        summary = _load_script("scripts/torch_int8_validation.py").main([
            "--abstracts", str(root / "abstracts.jsonl"), "--random-bert",
            "--tokenizer", str(root / "tokenizer"), "--n-docs", str(INT8_DOCS),
            "--n-queries", str(INT8_QUERIES), "--seq-len", "128"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    got = read_counts()
    for k, v in got.items():
        main[k] += v
    emit("int8_validation", card=CARD, seconds=seconds, summary=summary,
         launches={k: v for k, v in got.items() if v})
    return main


# ----------------------------------------------------------------------- mesh
MESH_SHARDS = 4        # serving ranks of the mesh phase, sharing cuda:0 over gloo
MESH_DATA = 3          # data ranks: the flagship's micro batch of 3, one row a rank


def _collective_bytes(bsz: int, k: int, d: int, shards: int) -> dict:
    """What a sharded fused query's collectives carry, from its shapes: the
    merge's all_gather of each rank's [B, k] f32 scores and int32 ids (the
    gathered block), the pool diameter's MIN and MAX all_reduce of [B, d] f32
    boxes, the scores' SUM all_reduce of [B, k] f32."""
    return {"merge_all_gather": shards * bsz * k * 8,
            "diameter_all_reduce": 2 * bsz * d * 4,
            "scores_all_reduce": bsz * k * 4}


def mesh_serve_rank(index_dir: str, n_docs: int) -> dict:
    """One serving rank of the mesh phase: its slice of the index phase's
    bf16 and int8 indexes on its device, then -- with the counts set to 0 --
    a single bf16 fused query (k=50: K8, K1), a batch of 32 int8 (k=64: K7,
    K1) and a pool ranking of 8 queries x 512 ids (K1), each sharded; then
    the same timed, and the stages' spans.  Returns answers, counts, times."""
    import torch.distributed as dist
    from aspire_tpu_torch.index.dense import (DenseBucketIndex,
                                              flatten_device_buckets)
    from aspire_tpu_torch.index.serve import (make_fused_query,
                                              make_fused_query_batched,
                                              make_pool_rank_batched)
    from aspire_tpu_torch.parallel.mesh import make_serving_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_serving_mesh(MESH_SHARDS)
    dev = mesh.device
    t0 = time.perf_counter()
    args = {}
    for storage in ("bfloat16", "int8"):
        idx = DenseBucketIndex.load(pathlib.Path(index_dir) / storage,
                                    mmap=True)
        args[storage] = (flatten_device_buckets(idx.device_arrays(mesh=mesh)),
                         idx.device_pos_arrays(mesh=mesh))
        nb = len(idx.buckets)
        del idx
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    q_np, q_lens_np, cand_np = index_query_inputs(n_docs)
    q, q_lens = (torch.from_numpy(x).to(dev) for x in (q_np, q_lens_np))
    cand = torch.from_numpy(cand_np).to(dev)
    kw = dict(max_sents=20, temp=5000.0, mesh=mesh)
    calls = {
        "single bf16": lambda: make_fused_query(nb, k=50, **kw)(
            q[0], q_lens[0], *args["bfloat16"][0], *args["bfloat16"][1]),
        "batch of 32 int8": lambda: make_fused_query_batched(
            nb, k=64, int8=True, **kw)(q, q_lens, *args["int8"][0],
                                       *args["int8"][1]),
        "pool rank": lambda: make_pool_rank_batched(
            nb, pool_size=512, agg="ot", **kw)(
                q[:8], q_lens[:8], cand, *args["bfloat16"][0],
                *args["bfloat16"][1])}
    for fn in calls.values():                   # warm-up, not counted
        fn()
    torch.cuda.synchronize()
    dist.barrier()
    reset_counts()
    answers = {name: fn() for name, fn in calls.items()}
    torch.cuda.synchronize()
    counts = read_counts()
    dist.barrier()
    times = {}
    for name, fn in calls.items():
        times[name], _ = _host_ms(fn)
        dist.barrier()
    # this rank's scan, the merge's all_gather, the gather of the candidates
    # it owns, the rerank (with the pool diameter's all_reduces) and the
    # scores' all_reduce (`reduce` holds the diameter's too)
    stages = {name: _stage_ms(calls[name], stages=("scan", "merge", "gather",
                                                   "rerank", "reduce"))
              for name in ("single bf16", "batch of 32 int8")}
    out = {name: tuple(x.cpu().numpy() for x in (a if isinstance(a, tuple)
                                                  else (a,)))
           for name, a in answers.items()}
    return {"answers": out, "counts": counts, "ms": times, "stages": stages,
            "load_s": load_s, "device": str(dev), "backend": mesh.backend,
            "peak_memory_mb": torch.cuda.max_memory_allocated(dev) / 2 ** 20}


def _first_step_check(model, trainer, state, superbatch, seed: int, n_micro,
                      mesh) -> tuple:
    """The first step's loss and gradient norms as train_step computes them
    (on a mesh: summed over the ranks), without taking the step."""
    from aspire_tpu_torch.parallel.mesh import all_reduce
    kw = {} if mesh is None else {"mesh": mesh, "n_micro": n_micro}
    sb = trainer.place(superbatch)
    loss, losses = model.train_loss_grouped(
        sb, torch.Generator().manual_seed(seed), True, **kw)
    loss.backward()
    if mesh is not None:
        trainer._sum_grads(state.optimizer)
        losses = all_reduce(losses.detach(), mesh)
    norms = _group_norms(model)
    state.optimizer.zero_grad(set_to_none=True)
    return float(losses.detach().sum()), norms


def _param_digest(model) -> str:
    import hashlib
    h = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


MESH_TRAIN_SEED = 11


def mesh_train_steps(layers: int):
    """The flagship's superbatches [10, 3, 512] of three steps, its run
    config (a dev check after the third step) and its dev batch of 3."""
    from aspire_tpu_torch.core.config import RunConfig, TrainHParams
    from aspire_tpu_torch.models.bert import BertConfig
    cfg = BertConfig(num_hidden_layers=layers)
    steps = [synth_superbatch(300 + i, 10, 3, 512, 20, cfg.vocab_size)
             for i in range(3)]
    dev_sb = synth_superbatch(400, 1, 3, 512, 20, cfg.vocab_size, neg=True)
    dev_batch = {k: {n: a[0] for n, a in v.items()} for k, v in dev_sb.items()}
    tp = TrainHParams(batch_size=3, accumulated_batch_size=30,
                      update_rule="adam", learning_rate=2e-5,
                      lr_decay_method="warmuplin", num_warmup_steps=20,
                      train_size=3000, es_check_every=30)
    return cfg, steps, tp, dev_batch


def mesh_train_rank(layers: int, run_dir: str) -> dict:
    """One data rank of the mesh phase: the flagship model (weights from
    seed 0) replicated from rank 0; the first step's loss and gradient
    norms; then, with the counts set to 0, Trainer.train for three steps
    (one wide encode of this rank's 10 of the window's 30 rows a side, a dev
    check after the third), each step's host milliseconds and this rank's
    peak memory.  Returns those and a digest of the parameters."""
    from aspire_tpu_torch.core.config import RunConfig
    from aspire_tpu_torch.parallel.mesh import make_mesh
    from aspire_tpu_torch.train.trainer import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(MESH_DATA)
    cfg, steps, tp, dev_batch = mesh_train_steps(layers)
    hp, model = flagship(cfg, mesh.device)
    trainer = Trainer(model, RunConfig(model=hp, train=tp), run_dir,
                      fused_accum=True, mesh=mesh)
    state = trainer.init_state()
    first = _first_step_check(model, trainer, state, steps[0], MESH_TRAIN_SEED,
                              10, mesh)
    torch.cuda.reset_peak_memory_stats(mesh.device)
    marks, counts = [], []
    reset_counts()
    state = trainer.train(state, _timed(steps, marks, counts),
                          dev_batches_fn=lambda: [dev_batch],
                          seed=MESH_TRAIN_SEED)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    counts.append(read_counts())
    return {"first_step": first, "counts": counts[-1],
            "per_step": [{k: b[k] - a[k] for k in a if b[k] != a[k]}
                         for a, b in zip(counts[:-1], counts[1:])],
            "step_ms": [(b - a) * 1e3 for a, b in zip(marks[:-1], marks[1:])],
            "losses": trainer.loss_history, "dev": trainer.dev_score_history,
            "steps": state.step, "digest": _param_digest(model),
            "peak_memory_mb": torch.cuda.max_memory_allocated(mesh.device)
            / 2 ** 20, "device": str(mesh.device), "backend": mesh.backend,
            "n_params": sum(p.numel() for p in model.parameters())}


def phase_mesh(dev, index_dir, index_docs: int, layers: int) -> dict:
    """Several ranks on the one card: (a) 4 serving ranks over gloo, sharing
    cuda:0, on the index phase's 125,000-document indexes, held to the
    one-process fused queries and pool ranking on the same index; (b) 3 data
    ranks over gloo training the flagship at BERT-base width, held to the
    one-process first step and to each other after three steps; (c) one
    step in this process as a world of one over NCCL.  The launch counts of
    (a) and (b) are each rank's (set to 0 before its run, read after) and
    are summed here; (c)'s are this process's."""
    import tempfile
    import torch.distributed as dist
    from aspire_tpu_torch.core.config import RunConfig
    from aspire_tpu_torch.index.dense import (DenseBucketIndex,
                                              flatten_device_buckets)
    from aspire_tpu_torch.index.serve import (make_fused_query,
                                              make_fused_query_batched,
                                              make_pool_rank_batched)
    from aspire_tpu_torch.parallel.mesh import (initialize_multihost,
                                                make_mesh, run_ranks)
    from aspire_tpu_torch.train.trainer import Trainer
    emit("mesh", card=CARD, serve={"ranks": MESH_SHARDS, "backend": "gloo",
                                   "devices": "cuda:0 for every rank"},
         train={"ranks": MESH_DATA, "backend": "gloo",
                "devices": "cuda:0 for every rank"},
         nccl={"ranks": 1, "backend": "nccl", "devices": "cuda:0"},
         note="the ranks share one card: NCCL across cards, P2P and NVLink "
              "are not exercised")
    launches = {name: 0 for name in counters()}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        if index_dir is None:
            index_dir = tmp
            build_large_index(None, index_docs, save_dir=index_dir)
        t0 = time.perf_counter()
        served = run_ranks(mesh_serve_rank, MESH_SHARDS, str(index_dir),
                           index_docs, device="cuda", backend="gloo",
                           colocate=True)
        serve_s = time.perf_counter() - t0
        # the one-process answers on the same index, through the kernels
        q_np, q_lens_np, cand_np = index_query_inputs(index_docs)
        q, q_lens = (torch.from_numpy(x).to(dev) for x in (q_np, q_lens_np))
        cand = torch.from_numpy(cand_np).to(dev)
        single = {}
        for storage in ("bfloat16", "int8"):
            idx = DenseBucketIndex.load(pathlib.Path(index_dir) / storage,
                                        mmap=True)
            flat = flatten_device_buckets(idx.device_arrays(dev))
            pos = idx.device_pos_arrays(dev)
            nb = len(idx.buckets)
            kw = dict(max_sents=20, temp=5000.0)
            if storage == "bfloat16":
                single["single bf16"] = tuple(
                    x[None] for x in make_fused_query(nb, k=50, **kw)(
                        q[0], q_lens[0], *flat, *pos))
                single["pool rank"] = make_pool_rank_batched(
                    nb, pool_size=512, agg="ot", **kw)(q[:8], q_lens[:8], cand,
                                                        *flat, *pos)
            else:
                single["batch of 32 int8"] = make_fused_query_batched(
                    nb, k=64, int8=True, **kw)(q, q_lens, *flat, *pos)
            del idx, flat, pos
        torch.cuda.empty_cache()
    for r in served[1:]:
        for name, got in r["answers"].items():
            for a, b in zip(got, served[0]["answers"][name]):
                if not np.array_equal(a, b):
                    raise AssertionError(f"mesh: ranks answer {name} apart")
    check = {}
    for name in ("single bf16", "batch of 32 int8"):
        got = tuple(torch.from_numpy(np.atleast_2d(x))
                    for x in served[0]["answers"][name])
        want = tuple(x.cpu() for x in single[name])
        check[name] = compare_answers(f"mesh {name}", got, want)
    live = cand_np >= 0
    got_pool = served[0]["answers"]["pool rank"][0]
    check["pool rank"] = check_close(
        "mesh pool rank", torch.from_numpy(got_pool[live]),
        single["pool rank"].cpu()[torch.from_numpy(live)], atol=1e-2, rtol=5e-3)
    if not (got_pool[~live] == -1e30).all():
        raise AssertionError("mesh pool rank: a pad slot scored")
    for r in served:
        for k, v in r["counts"].items():
            launches[k] += v
    per_query = {name: {"ms": served[0]["ms"][name], "batch": b, "k": k,
                        "collective_bytes": _collective_bytes(b, k, 768,
                                                              MESH_SHARDS)}
                 for name, b, k in (("single bf16", 1, 50),
                                    ("batch of 32 int8", 32, 64))}
    per_query["pool rank"] = {"ms": served[0]["ms"]["pool rank"], "batch": 8,
                              "pool": 512, "collective_bytes": {
                                  "scores_all_reduce": 8 * 512 * 4}}
    for name, stages in served[0]["stages"].items():
        per_query[name].update(stages)
        per_query[name]["ms_a_query"] = (per_query[name]["ms"]["warm_ms"]
                                         / per_query[name]["batch"])
    emit("mesh_serve", card=CARD, ranks=MESH_SHARDS, backend="gloo",
         docs=index_docs, seconds=serve_s, load_s=[r["load_s"] for r in served],
         queries=per_query, sharded_against_one_process=check,
         launches_per_rank=[{k: v for k, v in r["counts"].items() if v}
                            for r in served],
         peak_memory_mb=[r["peak_memory_mb"] for r in served],
         host_clock="rank 0's")

    # (b) data-parallel training
    cfg, steps, tp, _ = mesh_train_steps(layers)
    with tempfile.TemporaryDirectory(prefix="mesh_run_") as run_dir:
        t0 = time.perf_counter()
        trained = run_ranks(mesh_train_rank, MESH_DATA, layers, run_dir,
                            device="cuda", backend="gloo", colocate=True)
        train_s = time.perf_counter() - t0
        saved = sorted(p.name for p in pathlib.Path(run_dir).iterdir())
    hp, model = flagship(cfg, dev)
    trainer = Trainer(model, RunConfig(model=hp, train=tp), tempfile.mkdtemp(),
                      fused_accum=True)
    state = trainer.init_state()
    want = _first_step_check(model, trainer, state, steps[0], MESH_TRAIN_SEED,
                             10, None)
    tol = STEP_TOL[torch.bfloat16]
    digests = {r["digest"] for r in trained}
    for r in trained:
        loss, norms = r["first_step"]
        worst = max(abs(norms[g] - want[1][g]) / want[1][g] for g in want[1])
        if abs(loss - want[0]) > tol["loss_rel"] * abs(want[0]) \
                or not worst <= tol["grad_norm_rel"]:
            raise AssertionError(f"mesh train: first step {loss}, norms off by "
                                 f"{worst}, against one process {want[0]}")
        if r["steps"] != 3 or len(r["dev"]) != 1 or not all(
                math.isfinite(x) for x in r["losses"] + r["dev"]):
            raise AssertionError(f"mesh train: {r['steps']} steps, losses "
                                 f"{r['losses']}, dev {r['dev']}")
    if len(digests) != 1:
        raise AssertionError("mesh train: the ranks' parameters differ after "
                             "three steps")
    if not {"metrics.jsonl", "model_cur_best.pt", "model_final.pt",
            "run_info.json"} <= set(saved):
        raise AssertionError(f"mesh train: rank 0 wrote {saved}")
    for r in trained:
        for k, v in r["counts"].items():
            launches[k] += v
    n_params = trained[0]["n_params"]
    rel = max(abs(r["first_step"][0] - want[0]) / abs(want[0]) for r in trained)
    emit("mesh_train", card=CARD, ranks=MESH_DATA, backend="gloo",
         model="sbalisentbienc l2wasserstein", dtype="bfloat16", layers=layers,
         superbatch=[10, 3, 512], rows_a_rank=10, seconds=train_s,
         step_ms=[r["step_ms"] for r in trained],
         peak_memory_mb=[r["peak_memory_mb"] for r in trained],
         first_step_loss=[r["first_step"][0] for r in trained],
         one_process_first_step_loss=want[0], loss_rel_err=rel, tolerance=tol,
         params_equal_after_3_steps=True, run_dir_files=saved,
         launches_per_rank_per_step=[r["per_step"] for r in trained],
         collective_bytes_a_step={"gradient_all_reduce": 4 * n_params},
         losses=trained[0]["losses"], dev_score=trained[0]["dev"])
    del model, trainer, state
    torch.cuda.empty_cache()

    # (c) one step at a world of one over NCCL, in this process
    with tempfile.TemporaryDirectory(prefix="mesh_nccl_") as tmp:
        initialize_multihost("file://" + tmp + "/rendezvous", 1, 0,
                             backend="nccl", device="cuda")
        try:
            mesh = make_mesh(1)
            hp, model = flagship(cfg, dev)
            trainer = Trainer(model, RunConfig(model=hp, train=tp), tmp,
                              fused_accum=True, mesh=mesh)
            state = trainer.init_state()
            got = _first_step_check(model, trainer, state, steps[0],
                                    MESH_TRAIN_SEED, 10, mesh)
            base = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = trainer.train_step(state, trainer.place(steps[0]),
                                        torch.Generator().manual_seed(
                                            MESH_TRAIN_SEED), 10)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
            for k, v in read_counts().items():
                launches[k] += v - base[k]
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    worst = max(abs(got[1][g] - want[1][g]) / want[1][g] for g in want[1])
    if backend != "nccl" or abs(got[0] - want[0]) > tol["loss_rel"] * abs(want[0]) \
            or not worst <= tol["grad_norm_rel"] \
            or not bool(torch.isfinite(losses).all()) or state.step != 1:
        raise AssertionError(f"mesh nccl: {backend}, loss {got[0]} against "
                             f"{want[0]}, norms off by {worst}")
    emit("mesh_nccl", card=CARD, backend=backend, world=1, step_ms=step_ms,
         first_step_loss=got[0], one_process_first_step_loss=want[0],
         grad_norm_rel_worst=worst)
    return launches


# --------------------------------------------------------------------- ranges
RANGE_HEADS = 6                    # BERT-base width as 6 heads of 128
RANGE_CLI_LAYERS = 4               # depth of the local BERT directory (the CLI's run)
RANGE_DOCS = 2000                  # full-text documents of the long index
RANGE_SENTS = (240, 1200)          # their sentence counts, both ends taken
RANGE_BUCKETS = (400, 800, 1200)
RANGE_QUERY = 300                  # sentences of a full-text query
RANGE_K = 20
# an abstract's query against full-text documents: 20 sentences (the default
# max_sents is 24) against the long index's buckets of 400 and 800 sentences,
# fused queries at max_sents 800 (K1's wide pairs, 20 x 800)
ABSTRACT_SENTS = 20
ABSTRACT_MAX_SENTS = 800
# the noise, in spreads of the query's reps, of the rank CLI's planted near
# copies: their OT scores lie far apart in this order
RANGE_PLANT_NOISE = (0.05, 0.1, 0.2, 0.4, 0.8)


def range_encode(cfg, dev) -> dict:
    """A request (16 abstracts x 256 tokens) through ConSentEncoder with 6
    heads of 128, bf16 and f32, 'auto' (the wide K2) against 'naive', weights
    from a numpy seed.  Tolerances: bf16 the serve phase's 0.15 (8-bit
    roundings at each path's own places over every layer), f32 1e-3."""
    from aspire_tpu_torch.models.convert import state_dict_from_flax_params
    from aspire_tpu_torch.models.encoders import ConSentEncoder
    state = state_dict_from_flax_params(random_flax_tree(cfg, seed=0), cfg)
    token_ids, attn_mask, sent_ids, _ = make_request(cfg, 150, dev)
    rows = []
    for dtype, atol in ((torch.bfloat16, 0.15), (torch.float32, 1e-3)):
        outs = {}
        for impl in ("auto", "naive"):
            enc = ConSentEncoder(cfg, max_sents=20, dtype=dtype, device=dev,
                                 attention_impl=impl, ffn_impl=impl,
                                 pool_impl=impl).eval()
            enc.load_state_dict(state)
            before = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                outs[impl] = enc(token_ids, attn_mask, sent_ids)[1]
            torch.cuda.synchronize()
            outs[impl + "_ms"] = (time.perf_counter() - t0) * 1e3
            outs[impl + "_launches"] = {k: v - before[k] for k, v in read_counts().items()
                                        if v != before[k]}
            del enc
        got = outs["auto_launches"]
        wide = "attention_wide" if dtype == torch.bfloat16 else "attention_wide_f32"
        if got.get(wide) != cfg.num_hidden_layers or "attention" in got \
                or outs["naive_launches"]:
            raise AssertionError(f"ranges encode: launches {got}, naive "
                                 f"{outs['naive_launches']}")
        res = check_close(f"ranges encode {dtype}", outs["auto"], outs["naive"], atol)
        rows.append({"dtype": str(dtype).split(".")[-1], "launches": got,
                     "ms": outs["auto_ms"], "plain_ms": outs["naive_ms"], **res})
    return {"docs": 16, "tokens": 256, "rows": rows}


def range_train(cfg, dev) -> dict:
    """The flagship (sbalisentbienc) with 6 heads of 128 on [10, 3, 512]
    superbatches: the first step through the kernels against the plain path,
    bf16 and f32 (`kernel_against_plain_step`); then four optimizer steps
    through Trainer in bf16, and four in f32 (the model `train
    --no-bf16-compute` builds), each step's launches counted (the wide K5a
    and K5b of the step's dtype, none of the 64-wide ones nor of the other
    dtype): the first step's ms, the warm steps' (the second and third) and
    the last one's, which holds the trainer's closing checkpoint saves."""
    layers = cfg.num_hidden_layers
    steps = [synth_superbatch(700 + i, 10, 3, 512, 20, cfg.vocab_size) for i in range(4)]
    seed = 31
    first = {str(dt).split(".")[-1]: kernel_against_plain_step(cfg, dev, steps[0], seed, dt)
             for dt in (torch.bfloat16, torch.float32)}
    quiet = ("attention_dropout", "attention_bwd", "attention_dropout_f32",
             "attention_bwd_f32", "attention_dropout_wide", "attention_bwd_wide",
             "attention_dropout_wide_f32", "attention_bwd_wide_f32")
    out = {"superbatch": [10, 3, 512], "first_step": first}
    for dtype, suffix, loss_rel in ((torch.bfloat16, "", 1e-2), (torch.float32, "_f32", 1e-4)):
        # two encodes a step; a wide backward is three launches in bf16
        # (delta, keys, ds), two in f32 (scores, grads)
        want = dict.fromkeys(quiet, 0)
        want.update({"attention_dropout_wide" + suffix: 2 * layers,
                     "attention_bwd_wide" + suffix: (2 if suffix else 3) * 2 * layers,
                     "dropout": 2 * 2 * (1 + 2 * layers), "sinkhorn": 2})
        label = str(dtype).split(".")[-1]
        out[label] = _range_trainer_steps(cfg, dev, dtype, steps, seed, want,
                                          first[label]["loss_kernel"], loss_rel)
    # the contract's keys, the bf16 steps' as before
    out.update({k: out["bfloat16"][k] for k in (
        "step_ms", "first_step_ms", "warm_step_ms", "last_step_with_checkpoints_ms",
        "peak_memory_mb", "launches_per_step", "first_loss")})
    return out


def _range_trainer_steps(cfg, dev, dtype, steps, seed, want, first_kernel_loss,
                         loss_rel) -> dict:
    """len(steps) optimizer steps of the flagship in `dtype` through Trainer,
    each step's launches held to `want`, the first step's loss to the one
    held against the plain path."""
    import tempfile
    from aspire_tpu_torch.core.config import RunConfig, TrainHParams
    from aspire_tpu_torch.train.trainer import Trainer
    hp, model = flagship(cfg, dev, dtype=dtype)
    tp = TrainHParams(batch_size=3, accumulated_batch_size=30,
                      update_rule="adam", learning_rate=2e-5,
                      lr_decay_method="warmuplin", num_warmup_steps=20,
                      train_size=3000)
    torch.cuda.reset_peak_memory_stats()
    marks, counts = [], []
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(model, RunConfig(model=hp, train=tp), tmp, fused_accum=True)
        state = trainer.train(trainer.init_state(), _timed(steps, marks, counts),
                              seed=seed)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        counts.append(read_counts())
    label = str(dtype).split(".")[-1]
    for i, (a_, b_) in enumerate(zip(counts[:-1], counts[1:])):
        got = {k: b_[k] - a_[k] for k in want}
        if got != want:
            raise AssertionError(f"ranges train {label}: step {i} launched {got}, "
                                 f"expected {want}")
    losses = trainer.loss_history
    if state.step != len(steps) or not losses or not all(map(math.isfinite, losses)):
        raise AssertionError(f"ranges train {label}: step {state.step}, losses {losses}")
    first_loss = sum(losses[:10])
    if abs(first_loss - first_kernel_loss) > loss_rel * abs(first_loss):
        raise AssertionError(f"ranges train {label}: first loss {first_loss} against "
                             f"{first_kernel_loss}")
    step_ms = [(b_ - a_) * 1e3 for a_, b_ in zip(marks[:-1], marks[1:])]
    out = {"dtype": label, "step_ms": step_ms, "first_step_ms": step_ms[0],
           "warm_step_ms": step_ms[1:3], "last_step_with_checkpoints_ms": step_ms[3],
           "peak_memory_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
           "launches_per_step": want, "first_loss": first_loss}
    print(f"ranges train: {cfg.num_hidden_layers} layers of 6 heads of 128, {label}, "
          f"first step {step_ms[0]:.1f} ms, warm steps {step_ms[1]:.1f} and "
          f"{step_ms[2]:.1f} ms (host clock); {CARD}", flush=True)
    del model, trainer, state
    torch.cuda.empty_cache()
    return out


def range_cli_train(root: str, cfg, vocab: list, dev) -> dict:
    """A local BERT directory with 6 heads of 128 (RANGE_CLI_LAYERS deep),
    then `python -m aspire_tpu_torch train --init-hf-dir` on it for two
    steps, in a subprocess on the card; its run directory is what
    `range_rank` ranks with."""
    import dataclasses
    cfg = dataclasses.replace(cfg, num_hidden_layers=RANGE_CLI_LAYERS)
    write_hf_dir(f"{root}/hf", cfg, vocab, seed=41)
    write_triples(f"{root}/train.jsonl", vocab, seed=43, n=12)
    with open(f"{root}/cfg.json", "w") as f:
        json.dump({"model_name": "sbalisentbienc",
                   "score_aggregation": "l2wasserstein",
                   "sent_sm_temp": 5000.0, "sent_loss_prop": 1.0,
                   "sentsup_loss_prop": 1.0, "max_sents": 24,
                   "batch_size": 3, "accumulated_batch_size": 6,
                   "train_size": 12, "num_epochs": 1, "update_rule": "adam",
                   "learning_rate": 2e-5, "lr_decay_method": "warmuplin",
                   "num_warmup_steps": 2, "es_check_every": 10_000,
                   "base-pt-layer": f"{root}/hf"}, f)
    argv = [sys.executable, "-m", "aspire_tpu_torch", "train", "--config",
            f"{root}/cfg.json", "--train", f"{root}/train.jsonl", "--out",
            f"{root}/run", "--init-hf-dir", f"{root}/hf", "--seq-len", "512",
            "--seed", "5", "--device", dev.type]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0 or "trained 2 steps" not in proc.stdout:
        raise AssertionError(f"ranges: train --init-hf-dir exited "
                             f"{proc.returncode}: {proc.stdout[-2000:]}"
                             f"{proc.stderr[-4000:]}")
    with open(f"{root}/run/run_info.json") as f:
        bert = json.load(f)["all_hparams"]["bert_config"]
    if bert["num_attention_heads"] != cfg.num_attention_heads:
        raise AssertionError(f"ranges: the run's encoder has {bert}")
    return {"argv": argv[3:], "seconds": seconds, "heads": cfg.num_attention_heads,
            "head_width": cfg.hidden_size // cfg.num_attention_heads,
            "layers": cfg.num_hidden_layers,
            "stdout_tail": proc.stdout.strip().splitlines()[-1]}


def build_long_index(dev, pids: list, save_dir: str, plants: dict) -> dict:
    """A dense-bucket index of len(pids) documents of RANGE_SENTS sentences
    of 768-d reps (one normal draw on the card from a generator seeded 45,
    split into documents; their lengths from numpy seed 45; a document of
    `plants`, pid -> (reps [n, 768], noise), holds those reps repeated to its
    length plus normal noise of `noise` times their spread), built by
    build_dense_index in bf16 (also saved under save_dir, the rank CLI's
    index) and, quantised on the card, by build_dense_index_prequantized in
    int8 (build_dense_index's int8 rows and scales; norms within an f32
    rounding of its), both put on the card."""
    from aspire_tpu_torch.index.dense import (build_dense_index,
                                              build_dense_index_prequantized,
                                              quantize_sentences)
    rng = np.random.default_rng(45)
    d = 768
    t0 = time.perf_counter()
    lens = rng.integers(RANGE_SENTS[0], RANGE_SENTS[1] + 1, len(pids))
    cuts = np.cumsum(lens)[:-1]
    gen = torch.Generator(device=dev).manual_seed(45)
    flat_dev = torch.randn((int(lens.sum()), d), generator=gen, device=dev) * 2.0
    starts = np.concatenate([[0], cuts])
    row_of = {pid: i for i, pid in enumerate(pids)}
    for pid, (reps, noise) in plants.items():
        i = row_of[pid]
        base = torch.from_numpy(reps).to(dev)
        base = base[torch.arange(int(lens[i]), device=dev) % base.shape[0]]
        flat_dev[starts[i]:starts[i] + base.shape[0]] = base + noise * base.std() * \
            torch.randn(base.shape, generator=gen, device=dev)
    doc_reps = np.split(flat_dev.cpu().numpy(), cuts)
    xi, sc = quantize_sentences(flat_dev)
    quant = list(zip(np.split(xi.cpu().numpy(), cuts), np.split(sc.cpu().numpy(), cuts)))
    del flat_dev, xi, sc
    host_s = {"reps": time.perf_counter() - t0}
    big = {"docs": len(pids), "pids": pids, "planted": set(plants),
           "dim": d, "bucket_sizes": list(RANGE_BUCKETS),
           "sentences": int(lens.sum()), "lens": lens, "reps": doc_reps,
           "buckets": {}, "pos": {}, "stored": {}}
    for name in ("bfloat16", "int8"):
        t0 = time.perf_counter()
        if name == "int8":
            idx = build_dense_index_prequantized(quant, pids, buckets=RANGE_BUCKETS)
        else:
            idx = build_dense_index(doc_reps, pids, buckets=RANGE_BUCKETS, dtype=name)
        host_s[f"build_{name}"] = time.perf_counter() - t0
        big["buckets"][name] = idx.device_arrays(dev)
        big["pos"][name] = idx.device_pos_arrays(dev)
        big["stored"][name] = sum(a.nbytes for b in idx.buckets for a in b.values())
        if name == "bfloat16":
            t0 = time.perf_counter()
            idx.save(save_dir)
            host_s["save_bfloat16"] = time.perf_counter() - t0
        del idx
    big["host_seconds"] = host_s
    return big


def range_fused_queries(big: dict, dev, add, sents: int = RANGE_QUERY,
                        max_sents: int = RANGE_SENTS[1], n_buckets: int = None,
                        scans=("scan_bf16_wide", "scan_int8_wide"),
                        solver: str = "sinkhorn_large") -> list:
    """Fused queries of `sents` sentences (an unplanted document's own first
    sentences plus unit noise, the document at most max_sents long) on the
    long index's first n_buckets buckets (all by default; the position
    arrays whole): one on bf16 and a batch of 8 on int8, each launching
    `scans` (a launch a bucket) and one K1 kernel, `solver`.  Full-text
    queries by default (300 sentences: K8 with its three groups of 128 rows
    in one launch a bucket, K7 with the groups as extra queries, then K1's
    large pairs, 300 x up to 1,200); an abstract's (ABSTRACT_SENTS against
    the buckets of 400 and 800 at ABSTRACT_MAX_SENTS: the narrow K8, the
    wide K7, then K1's wide pairs, 20 x 800).  Each held to the same search
    with the plain scan and solver='torch' (the ids, the first-stage and
    the OT scores, `compare_answers`), the document itself first, and its
    rerank to the plain solver in f64 (`_rerank_witness`)."""
    from aspire_tpu_torch.index.dense import flatten_device_buckets
    from aspire_tpu_torch.index.serve import (make_fused_query,
                                              make_fused_query_batched)
    from aspire_tpu_torch.ops.scan_kernel import query_cap
    rng = np.random.default_rng(46)
    long_docs = [i for i, (n, pid) in enumerate(zip(big["lens"], big["pids"]))
                 if sents <= n <= max_sents and pid not in big["planted"]][:8]
    # unit noise on reps of spread 2: the document stays first by far, and
    # its first-stage distance stays clear of the Gram expansion's
    # cancellation (|q|^2 + |x|^2 - 2 q.x of a near copy is all rounding)
    q = np.stack([big["reps"][i][:sents] for i in long_docs])
    q = q + rng.standard_normal(q.shape, dtype=np.float32)
    q_all = torch.from_numpy(q).to(dev)
    q_lens = torch.full((len(long_docs),), sents, dtype=torch.int64, device=dev)
    groups = -(-sents // query_cap(torch.bfloat16, 768))
    rows = []
    for label, storage, bsz, scan in (("single bf16", "bfloat16", 1, scans[0]),
                                      ("batch of 8 int8", "int8", 8, scans[1])):
        int8 = storage == "int8"
        buckets = big["buckets"][storage][:n_buckets]
        pos = big["pos"][storage]
        nb = len(buckets)
        flat = flatten_device_buckets(buckets)
        kw = dict(k=RANGE_K, max_sents=max_sents, int8=int8, temp=5000.0)
        want = {scan: nb, solver: 1}
        if bsz == 1:
            fn_k = make_fused_query(nb, **kw)
            fn_p = make_fused_query(nb, scan="torch", solver="torch", **kw)
            call = lambda fn: tuple(x[None] for x in fn(q_all[0], sents, *flat, *pos))
        else:
            fn_k = make_fused_query_batched(nb, **kw)
            fn_p = make_fused_query_batched(nb, scan="torch", solver="torch",
                                            q_chunk=1, **kw)
            call = lambda fn: fn(q_all, q_lens, *flat, *pos)
        before = read_counts()
        t_k, out_k = _host_ms(lambda: call(fn_k), calls=2)
        after = read_counts()
        add(before, after)
        got = {k: (after[k] - before[k]) // 3 for k in after if after[k] != before[k]}
        if got != want:
            raise AssertionError(f"ranges {label}: a call launched {got}, expected {want}")
        before = read_counts()
        t_p, out_p = _host_ms(lambda: call(fn_p), calls=1)
        if read_counts() != before:
            raise AssertionError(f"ranges {label}: the plain route launched kernels")
        v, ids, sims = out_k
        if tuple(ids.shape) != (bsz, RANGE_K) or int((ids < 0).sum()) \
                or not bool(torch.isfinite(sims).all()) \
                or ids[:, 0].tolist() != long_docs[:bsz]:
            raise AssertionError(f"ranges {label}: malformed answer, first ids "
                                 f"{ids[:, 0].tolist()} for documents {long_docs[:bsz]}")
        rows.append({"query": label, "storage": storage, "batch": bsz,
                     "query_sentences": sents, "query_groups": groups,
                     "k": RANGE_K, "max_sents": max_sents, "buckets": nb, **t_k,
                     "plain_route": t_p, "launches_a_call": got,
                     "ids_equal": bool(torch.equal(out_k[1], out_p[1])),
                     "kernel_against_plain": compare_answers(label, out_k, out_p),
                     "rerank_f64": _rerank_witness(label, buckets, pos, q_all[:bsz],
                                                   q_lens[:bsz], ids, max_sents),
                     **_stage_ms(lambda: call(fn_k), calls=2)})
    return rows


def _rerank_witness(label, buckets, pos, q, q_lens, ids,
                    max_sents: int = RANGE_SENTS[1]) -> dict:
    """A fused query's rerank of its own candidates once more, on the same
    gathered reps and diameter: K1, the plain solver in f32 and the plain
    solver in f64 (`f64_witness`)."""
    from aspire_tpu_torch.core.types import MultiVec
    from aspire_tpu_torch.index.serve import _gather_candidates, _tile_queries
    from aspire_tpu_torch.ops.distances import wasserstein_dist
    from aspire_tpu_torch.ops.sinkhorn import grouped_max_diameter
    sims = {}
    with torch.no_grad():
        emb, cl, _, _ = _gather_candidates(buckets, *pos, ids.reshape(-1), max_sents)
        qt = _tile_queries(q, q_lens, ids.shape[1])
        diam = grouped_max_diameter(qt.embed, emb, q.shape[0])
        for name, dtype, solver in (("kernel", torch.float32, "kernel"),
                                    ("plain", torch.float32, "torch"),
                                    ("f64", torch.float64, "torch")):
            sims[name] = wasserstein_dist(
                MultiVec(qt.embed.to(dtype), qt.lens), MultiVec(emb.to(dtype), cl),
                temp=5000.0, return_pair_sims=True, solver=solver,
                diameter_value=diam.to(dtype))[0]
    return {"kernel_against_plain": float((sims["kernel"] - sims["plain"]).abs().max()),
            **f64_witness(f"ranges {label} rerank", sims["kernel"], sims["plain"],
                          sims["f64"])}


def _ranked(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _rank_argv(root: str, dev) -> list:
    return ["rank", "--index", f"{root}/index", "--dataset", "csfcube",
            "--dataset-dir", f"{root}/data", "--model", "sbalisentbienc",
            "--run-dir", f"{root}/run", "--tokenizer", f"{root}/hf",
            "--facet", "background", "--rerank", "ot", "--max-sents",
            str(RANGE_SENTS[1]), "--ot-temp", "5000.0", "--no-dumps",
            "--device", dev.type]


def range_plants(root: str, dev) -> dict:
    """The rank CLI's queries, encoded in this process by the CLI's own
    functions with the run that `range_cli_train` trained: each query's near
    copies in its pool (write_csfcube's q-n0 ... q-n4) are planted in the long
    index as the query's reps plus noise of RANGE_PLANT_NOISE[j] spreads
    -> {pid: (reps, noise)} for `build_long_index`."""
    from aspire_tpu_torch.cli import _load_eval_model, _query_rows, build_parser
    from aspire_tpu_torch.evaluation.datasets import EvalDataset
    args = build_parser().parse_args(_rank_argv(root, dev) + ["--out", f"{root}/plants"])
    dataset = EvalDataset(args.dataset, args.dataset_dir)
    model = _load_eval_model(args)
    qpids = list(dataset.get_test_pool(facet=args.facet))
    rows = _query_rows(args, dataset, model, qpids,
                       model.get_encoding(qpids, dataset), cosine=False)
    del model
    torch.cuda.empty_cache()
    return {f"{q}-n{j}": (reps, noise) for q, reps in zip(qpids, rows)
            for j, noise in enumerate(RANGE_PLANT_NOISE)}


def range_rank(root: str, big: dict, add, dev) -> dict:
    """`python -m aspire_tpu_torch rank --rerank ot --max-sents 1200` (the
    pool protocol, facet background) over the long index with the run that
    `range_cli_train` trained: its queries (up to 24 sentences, encoded in
    f32 through the wide K2) against candidates of up to 1,200 sentences need
    K1's large pairs.  Held to the same ranking with `--ot-solver xla` (the
    plain loop): each query's top 5 are its planted near copies in the order
    of their noise (`range_plants`) in both rankings; below them the same
    order wherever neighbouring scores are apart; every score within K1's
    limits for scores (2e-3 + 2e-3 relative)."""
    common = _rank_argv(root, dev)
    name = "test-pid2pool-csfcube-sbalisentbienc-background-ranked.json"
    before = read_counts()
    t0 = time.perf_counter()
    _cli(common + ["--out", f"{root}/ranked_kernel"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    after = read_counts()
    add(before, after)
    got = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    if not got.get("sinkhorn_large") or not got.get("attention_wide_f32") \
            or got.get("attention"):
        raise AssertionError(f"ranges rank: launched {got}")
    before = read_counts()
    t0 = time.perf_counter()
    _cli(common + ["--out", f"{root}/ranked_plain", "--ot-solver", "xla"])
    plain_s = time.perf_counter() - t0
    if read_counts()["sinkhorn_large"] != before["sinkhorn_large"]:
        raise AssertionError("ranges rank: --ot-solver xla launched K1")
    k_rank = _ranked(f"{root}/ranked_kernel/{name}")
    p_rank = _ranked(f"{root}/ranked_plain/{name}")
    if set(k_rank) != set(p_rank):
        raise AssertionError("ranges rank: the two runs ranked other queries")
    worst, moved, pairs, gap = 0.0, 0, 0, math.inf
    for qpid, ranked in k_rank.items():
        plain = p_rank[qpid]
        pk, pp = dict(map(tuple, ranked)), dict(map(tuple, plain))
        if set(pk) != set(pp):
            raise AssertionError(f"ranges rank: query {qpid}: other candidates")
        for c, s in pk.items():
            if not abs(s - pp[c]) <= 2e-3 + 2e-3 * abs(pp[c]):
                raise AssertionError(f"ranges rank: query {qpid}, candidate {c}: "
                                     f"{s} against {pp[c]}")
            worst = max(worst, abs(s - pp[c]))
        planted = [f"{qpid}-n{j}" for j in range(len(RANGE_PLANT_NOISE))]
        top = len(planted)
        if [c for c, _ in ranked[:top]] != planted or [c for c, _ in plain[:top]] != planted:
            raise AssertionError(f"ranges rank: query {qpid}: top {top} "
                                 f"{[c for c, _ in ranked[:top]]} (kernel), "
                                 f"{[c for c, _ in plain[:top]]} (plain), planted {planted}")
        gap = min(gap, min(a - b for (_, a), (_, b) in zip(plain[:top], plain[1:top + 1])))
        scores = [s for _, s in plain]
        for pos, ((a, _), (b, _)) in enumerate(zip(ranked, plain)):
            if a != b:
                near = [abs(scores[pos] - scores[o]) for o in (pos - 1, pos + 1)
                        if 0 <= o < len(scores)]
                if min(near) > 2 * (2e-3 + 2e-3 * abs(scores[pos])):
                    raise AssertionError(f"ranges rank: query {qpid}: order "
                                         "differs where the scores are apart")
                moved += 1
        pairs += len(pk)
    cands = {c for ranked in k_rank.values() for c, _ in ranked}
    pid_len = dict(zip(big["pids"], big["lens"].tolist()))
    return {"argv": common[1:], "queries": len(k_rank), "pairs": pairs,
            "candidate_sentences_max": max(pid_len[c] for c in cands),
            "seconds": seconds, "plain_seconds": plain_s, "launches": got,
            "max_score_diff": worst, "top_equal": len(RANGE_PLANT_NOISE),
            "top_least_gap": gap, "positions_differing_below": moved}


def phase_ranges(dev, layers: int) -> dict:
    """The kernels' input ranges on their paths: BERT-base width with 6 heads
    of 128 (encode, training steps, `train --init-hf-dir`), then full-text
    documents (an index of 2,000 documents of 240-1,200 sentences, fused
    queries of 300 sentences; an abstract's queries of 20 sentences against
    its buckets of up to 800, K1's wide pairs; the rank CLI at --max-sents
    1200).  The counts
    are set to 0 at the start; the plain routes' runs launch nothing, and the
    CLI's plain run is left out of the sum."""
    import tempfile
    from aspire_tpu_torch.models.bert import BertConfig
    torch.cuda.empty_cache()
    reset_counts()
    launches = dict.fromkeys(read_counts(), 0)

    def add(before, after):
        for k in launches:
            launches[k] += after[k] - before[k]

    cfg = BertConfig(num_hidden_layers=layers, num_attention_heads=RANGE_HEADS)
    seconds = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    before = read_counts()
    encode = range_encode(cfg, dev)
    lap("encode")
    train = range_train(cfg, dev)
    lap("train")
    add(before, read_counts())
    vocab = eval_vocab(cfg.vocab_size)
    with tempfile.TemporaryDirectory(prefix="ranges_") as root:
        cli_train = range_cli_train(root, cfg, vocab, dev)
        lap("cli_train")
        write_csfcube(f"{root}/data", vocab, seed=44, n_docs=RANGE_DOCS)
        with open(f"{root}/data/abstracts-csfcube.jsonl") as f:
            pids = [json.loads(line)["paper_id"] for line in f]
        lap("dataset")
        plants = range_plants(root, dev)
        lap("plants")
        big = build_long_index(dev, pids, f"{root}/index", plants)
        lap("index")
        queries = range_fused_queries(big, dev, add)
        lap("queries")
        abstracts = range_fused_queries(
            big, dev, add, ABSTRACT_SENTS, ABSTRACT_MAX_SENTS,
            n_buckets=RANGE_BUCKETS.index(ABSTRACT_MAX_SENTS) + 1,
            scans=("scan_bf16", "scan_int8_wide"), solver="sinkhorn_wide")
        lap("abstract_queries")
        rank = range_rank(root, big, add, dev)
        lap("rank")
    emit("ranges", card=CARD, seconds=seconds, layers=layers, hidden=cfg.hidden_size,
         heads=RANGE_HEADS, head_width=cfg.hidden_size // RANGE_HEADS,
         encode=encode, train=train, cli_train=cli_train,
         index={"docs": big["docs"], "sentences": big["sentences"],
                "sentences_a_document": list(RANGE_SENTS),
                "buckets": big["bucket_sizes"], "stored_bytes": big["stored"],
                "host_seconds": big["host_seconds"],
                "built_by": "build_dense_index (bf16) and build_dense_index_prequantized "
                            "(int8, quantised on the card) on the host, from reps drawn "
                            "on the card"},
         queries=queries, abstract_queries=abstracts, rank=rank, launches=launches)
    del big
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------- pools
POOL_DOCS = 100_000        # torch_pool_bench.py's corpus: one bucket of 12 sentences
POOL_SIZE, POOL_BATCH = 2048, 8
POOL_PADS = 48             # pad slots at the end of the last query's pool
POOL_SAMPLES = 16          # (query, candidate) pairs rescored alone


def phase_pools(dev) -> tuple:
    """The twins of bench.py's headline and of the deep-pool bench at
    full size, through benchmarks/torch_bench.py's and torch_pool_bench.py's
    own inputs and calls.  With the counts at 0: the headline call (1,024
    pairs of up to 20 x 20, diameter 'global', solver 'kernel': one K1
    launch), then one OT pool ranking of 8 queries x 2,048 candidates from
    a bf16 bucket of 100,000 documents on the card (48 pad slots in the last
    pool; the gathered block cut at 7 queries: two K1 launches).  Then the
    same through solver 'torch': the headline's sims within K1's
    `case_sinkhorn` limits (2e-3 + 2e-3 relative), the pool's live slots at
    the pool ranking's (1e-2 + 5e-3 relative), its pad slots at -1e30; 16
    sampled pairs rescored alone (diameter 'pair': a pair's score does not
    depend on its batch) equal their slots within the pool's limits.  Last
    K1 at the path's shapes against its plain version (B=1,024 20 x 20;
    B=14,336 and 2,048 16 x 24)."""
    from aspire_tpu_torch.core.types import MultiVec
    from aspire_tpu_torch.index.serve import _query_chunks, make_pool_rank_batched
    from aspire_tpu_torch.ops.distances import wasserstein_dist
    bench = _load_script("benchmarks/torch_bench.py")
    deep = _load_script("benchmarks/torch_pool_bench.py")
    smax, sents, qmax = 24, 12, 16
    q, c = bench.draw_pairs(bench.BATCH, 0, dev)
    flat, pos = deep.synth_bucket(POOL_DOCS, sents, 0, dev)
    pq, pql, cand = deep.pool_queries(POOL_BATCH, qmax, POOL_SIZE, POOL_DOCS, 1, dev)
    cand[-1, -POOL_PADS:] = -1
    live = cand >= 0

    def ranker(solver):
        return make_pool_rank_batched(1, pool_size=POOL_SIZE, max_sents=smax,
                                      agg="ot", temp=5000.0, solver=solver)

    pool_args = (pq, pql, cand, *flat, *pos)
    rank_k, rank_t = ranker("kernel"), ranker("torch")
    torch.cuda.synchronize()
    reset_counts()
    sims_k = bench.score(q, c)
    torch.cuda.synchronize()
    headline_counts = {k: v for k, v in read_counts().items() if v}
    pool_k = rank_k(*pool_args)
    torch.cuda.synchronize()
    counts = read_counts()
    pool_counts = {k: v - headline_counts.get(k, 0) for k, v in counts.items()
                   if v - headline_counts.get(k, 0)}
    step = _query_chunks(POOL_BATCH, POOL_SIZE, smax, 768, None)
    k1_batches = [POOL_SIZE * min(step, POOL_BATCH - i)
                  for i in range(0, POOL_BATCH, step)]
    if headline_counts != {"sinkhorn": 1} or pool_counts != {"sinkhorn": len(k1_batches)}:
        raise AssertionError(f"pools: the headline launched {headline_counts}, the "
                             f"deep pool {pool_counts} ({k1_batches} pairs a solve)")
    sims_t = bench.score(q, c, "torch")
    headline_err = check_close("pools: headline sims", sims_k, sims_t,
                               atol=2e-3, rtol=2e-3)
    pool_t = rank_t(*pool_args)
    if not bool((pool_k[~live] == -1e30).all()) or not bool(torch.isfinite(pool_k).all()):
        raise AssertionError("pools: a pad slot scored, or a score is not finite")
    pool_err = check_close("pools: deep pool", pool_k[live], pool_t[live],
                           atol=1e-2, rtol=5e-3)
    # a pair rescored alone: its candidate's rows padded to smax, as gathered
    pick = np.random.default_rng(5)
    qi = pick.integers(0, POOL_BATCH, POOL_SAMPLES)
    cj = pick.integers(0, POOL_SIZE - POOL_PADS, POOL_SAMPLES)
    alone = []
    for i, j in zip(qi.tolist(), cj.tolist()):
        reps = torch.zeros((1, smax, 768), device=dev)
        reps[0, :sents] = flat[0][cand[i, j].long()].float()
        s, _ = wasserstein_dist(
            MultiVec(pq[i:i + 1], pql[i:i + 1]),
            MultiVec(reps, torch.full((1,), sents, dtype=torch.int32, device=dev)),
            temp=5000.0, return_pair_sims=True, diameter="pair", solver="kernel")
        alone.append(s[0])
    alone_err = check_close("pools: pairs rescored alone", torch.stack(alone),
                            pool_k[torch.from_numpy(qi).to(dev), torch.from_numpy(cj).to(dev)],
                            atol=1e-2, rtol=5e-3)
    t_head = cuda_ms(lambda: bench.score(q, c))
    t_head_plain = cuda_ms(lambda: bench.score(q, c, "torch"))
    t_pool, _ = _host_ms(lambda: rank_k(*pool_args))
    t_pool_plain, _ = _host_ms(lambda: rank_t(*pool_args), calls=2)
    del flat, pos, pool_k, pool_t
    torch.cuda.empty_cache()
    cases = {"sinkhorn": [case_sinkhorn(bench.BATCH, "global", dev)]
             + [case_sinkhorn(pairs, "pair", dev, qmax, smax) for pairs in k1_batches]}
    emit("kernel_cases", kernel="sinkhorn", path="pools", cases=cases["sinkhorn"])
    emit("pools", card=CARD,
         headline={"pairs": bench.BATCH, "shape": "20 x 20, lens 4-20, 768-d",
                   "diameter": "global", "kernel_ms": t_head,
                   "pairs_per_s": bench.BATCH / t_head["median"] * 1e3,
                   "plain_ms": t_head_plain, "launches_a_call": headline_counts,
                   "kernel_against_plain": headline_err},
         deep_pool={"docs": POOL_DOCS, "sentences": sents, "pool": POOL_SIZE,
                    "queries": POOL_BATCH, "max_sents": smax, "qmax": qmax,
                    "pad_slots": POOL_PADS, "queries_a_gather": step,
                    "pairs_a_solve": k1_batches, "launches_a_call": pool_counts,
                    **t_pool, "ms_a_query": t_pool["warm_ms"] / POOL_BATCH,
                    "plain_route": t_pool_plain,
                    "kernel_against_plain": pool_err,
                    "pairs_alone_against_slots": {"pairs": POOL_SAMPLES, **alone_err}},
         launches={k: v for k, v in counts.items() if v})
    return cases, counts


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
    ("attention_dropout_f32", "aspire_tpu_torch/csrc/attention.cu",
     "aspire_tpu/ops/pallas_attention.py:210"),
    ("attention_bwd_f32", "aspire_tpu_torch/csrc/attention_bwd.cu",
     "aspire_tpu/ops/pallas_attention.py:229"),
    ("dropout", "aspire_tpu_torch/csrc/dropout.cu",
     "aspire_tpu/ops/pallas_dropout.py:110"),
    ("pool", "aspire_tpu_torch/csrc/pool.cu",
     "aspire_tpu/ops/pallas_pool.py:81"),
    ("scan_bf16", "aspire_tpu_torch/csrc/scan.cu",
     "aspire_tpu/ops/pallas_scan.py:77"),
    ("scan_int8", "aspire_tpu_torch/csrc/scan.cu",
     "aspire_tpu/ops/pallas_scan.py:180"),
    ("scan_int8_wide", "aspire_tpu_torch/csrc/scan_int8.cu",
     "aspire_tpu/ops/pallas_scan.py:180"),
    # K8 on bf16 rows for queries of full column groups (full-text queries)
    ("scan_bf16_wide", "aspire_tpu_torch/csrc/scan_int8.cu",
     "aspire_tpu/ops/pallas_scan.py:77"),
    # the wide heads (attention.cu, attention_bwd.cu at the head's width),
    # bf16 and f32 apart
    ("attention_wide", "aspire_tpu_torch/csrc/attention.cu",
     "aspire_tpu/ops/pallas_attention.py:210"),
    ("attention_dropout_wide", "aspire_tpu_torch/csrc/attention.cu",
     "aspire_tpu/ops/pallas_attention.py:210"),
    ("attention_bwd_wide", "aspire_tpu_torch/csrc/attention_bwd.cu",
     "aspire_tpu/ops/pallas_attention.py:229"),
    ("attention_wide_f32", "aspire_tpu_torch/csrc/attention.cu",
     "aspire_tpu/ops/pallas_attention.py:210"),
    ("attention_dropout_wide_f32", "aspire_tpu_torch/csrc/attention.cu",
     "aspire_tpu/ops/pallas_attention.py:210"),
    ("attention_bwd_wide_f32", "aspire_tpu_torch/csrc/attention_bwd.cu",
     "aspire_tpu/ops/pallas_attention.py:229"),
    ("sinkhorn_large", "aspire_tpu_torch/csrc/sinkhorn.cu",
     "aspire_tpu/ops/pallas_sinkhorn.py:164"),
    # the wide pairs (33 to 1,024 atoms a side within one block)
    ("sinkhorn_wide", "aspire_tpu_torch/csrc/sinkhorn.cu",
     "aspire_tpu/ops/pallas_sinkhorn.py:164"),
]


# the kernels each path must launch (its counts are set to 0 just before it
# is driven and read just after)
PATH_KERNELS = {
    "serve": ("sinkhorn", "attention", "ffn", "pool"),
    "train": ("sinkhorn", "attention", "ffn", "attention_dropout",
              "attention_bwd", "dropout", "pool"),
    "train_f32": ("sinkhorn", "attention_dropout_f32", "attention_bwd_f32",
                  "dropout"),
    "index": ("sinkhorn", "attention", "ffn", "pool", "scan_bf16", "scan_int8",
              "scan_int8_wide"),
    "eval": ("sinkhorn", "attention", "ffn", "pool", "attention_dropout",
             "attention_bwd", "dropout"),
    "chain": ("sinkhorn", "attention", "ffn", "pool", "attention_dropout",
              "attention_bwd", "dropout"),
    "families": ("sinkhorn", "attention", "ffn", "pool"),
    "checks": ("attention_dropout", "attention_bwd", "dropout", "sinkhorn",
               "attention", "ffn", "pool", "scan_bf16", "scan_int8"),
    "mesh": ("sinkhorn", "scan_bf16", "scan_int8_wide", "attention_dropout",
             "attention_bwd", "dropout", "pool", "attention", "ffn"),
    "pools": ("sinkhorn",),
    "ranges": ("attention_wide", "attention_dropout_wide", "attention_bwd_wide",
               "attention_wide_f32", "attention_dropout_wide_f32",
               "attention_bwd_wide_f32",
               "sinkhorn_large", "sinkhorn_wide", "scan_bf16_wide", "scan_int8_wide",
               "sinkhorn", "ffn", "dropout", "pool"),
}


def timed(phase: str, fn, *args):
    """fn(*args), its seconds on the host's clock printed as a line."""
    t0 = time.perf_counter()
    out = fn(*args)
    emit("phase_seconds", of=phase, seconds=time.perf_counter() - t0)
    return out


def run(args) -> dict:
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        return _run(args, tmp)


def _run(args, tmp: str) -> dict:
    dev = torch.device("cuda", 0)
    # references and scoring run in full float32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device()
    timed("build", phase_build)
    cases, launches = {}, {}

    def add(found: dict) -> None:
        for name, rows in found.items():
            cases.setdefault(name, []).extend(rows)

    if args.phases in ("all", "kernels"):
        cases = timed("kernels", phase_kernels, dev)
    if args.phases in ("all", "index"):
        cases["pool"] = phase_pool_kernel(dev)
    if args.phases == "all":
        launches["serve"] = timed("serve", phase_serve, dev, args.layers)
        launches["train"] = timed("train", phase_train, dev, args.train_layers)
        launches["train_f32"] = timed("train_f32", phase_train_f32, dev,
                                      args.train_layers)
    index_dir = None
    if args.phases in ("all", "index"):
        if args.phases == "all":
            index_dir = pathlib.Path(tmp) / "index"     # the mesh phase's
        scan_cases, launches["index"] = timed(
            "index", phase_index, dev, args.layers, args.encode_docs,
            args.index_docs, index_dir)
        cases.update(scan_cases)
    if args.phases in ("all", "mesh"):
        launches["mesh"] = timed("mesh", phase_mesh, dev, index_dir,
                                 args.index_docs, args.train_layers)
    if args.phases in ("all", "eval"):
        found, launches["eval"] = timed("eval", phase_eval, dev)
        add(found)
    if args.phases in ("all", "chain"):
        found, launches["chain"] = timed("chain", phase_chain, dev)
        add(found)
    if args.phases in ("all", "families"):
        found, launches["families"] = timed("families", phase_families, dev)
        add(found)
    if args.phases in ("all", "checks"):
        launches["checks"] = timed("checks", phase_checks, dev)
    if args.phases in ("all", "pools"):
        found, launches["pools"] = timed("pools", phase_pools, dev)
        add(found)
    if args.phases == "ranges":
        for name, rows in timed("range_kernels", range_kernel_cases, dev).items():
            cases[name] = rows
            emit("kernel_cases", kernel=name, cases=rows)
    if args.phases in ("all", "ranges"):
        launches["ranges"] = timed("ranges", phase_ranges, dev, args.train_layers)
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
                        help="depth of the bf16 and the f32 training models "
                             "(widths stay BERT-base)")
    parser.add_argument("--encode-docs", type=int, default=512,
                        help="abstracts the index phase encodes")
    parser.add_argument("--index-docs", type=int, default=125_000,
                        help="documents of the index the queries run on")
    parser.add_argument("--phases", default="all",
                        choices=("all", "index", "kernels", "eval", "chain",
                                 "families", "checks", "mesh", "pools", "ranges"),
                        help="'index' drives the index path alone (the pool "
                             "and scan kernels' cases, encode, queries); "
                             "'kernels' holds K1-K3 and K5a-K6 against their "
                             "plain versions and drives no path; 'eval' drives "
                             "the CLI's evaluate and train alone; 'chain' the "
                             "data pipeline's two-model chain alone; "
                             "'families' the examples and the RoBERTa / MPNet "
                             "baselines alone; 'checks' the convergence and "
                             "int8 checks alone; 'mesh' the several-rank "
                             "paths alone (sharded serving, data-parallel "
                             "training, a world of one over NCCL); 'pools' "
                             "the headline's and the deep pools' twins "
                             "alone; 'ranges' "
                             "the kernels' wide-head, large-pair and "
                             "grouped-query cases and their paths alone")
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
