"""Builds the package's CUDA sources into one shared library and loads it.

Every ``csrc/*.cu`` is compiled by a single nvcc command (``--threads`` lets it
work on the files side by side) into a library with a plain C interface, which
is loaded with ctypes: the sources include none of PyTorch's headers, so the
build takes seconds.  The library lands in ``build/aspire_tpu_torch/`` beside
the package, named after a hash of the sources, and is built at the first
kernel call -- importing this module needs neither nvcc nor a GPU.  Ranks that
start together (parallel/mesh.py) build it once: the first to take the
directory's lock builds, the others wait for it and load its library.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aspire_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL, _U64, _U32 = ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_uint
# dropout mode and bits: mode (0 none, 1 Philox, 2 operand), seed, counter
# word 0, keep threshold, the place of the first plane (attention) or row
# (hidden dropout) in the whole batch
_DROP = [_I, _U64, _U32, _U32, _U32]

# name -> argtypes; every function returns the cudaError_t of its launch.
# Without argtypes ctypes would pass each pointer as a 32-bit int.
SIGNATURES = {
    # the small pairs: cost, log_a, log_b, diam, f, g, bsz, n, m, blur,
    # log(scaling), max_iters, extrapolate (0: the loop's own f and g), stream
    "aspire_sinkhorn_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _P],
    # the wide pairs: cost, log_a, log_b, diam, f, g, bsz, n, m, lanes an O
    # atom, threads a block, blur, log(scaling), max_iters, extrapolate, stream
    # (ops/sinkhorn_kernel.wide_plan)
    "aspire_sinkhorn_wide_f32": [_P] * 6 + [_I] * 5 + [_F, _F, _I, _I, _P],
    # the large pairs: cost, log_a, log_b, diam, f, g, bsz, n, m, blocks a
    # pair, resident rows, blur, log(scaling), max_iters, extrapolate, stream
    # (ops/sinkhorn_kernel.cluster_plan)
    "aspire_sinkhorn_large_f32": [_P] * 6 + [_I] * 5 + [_F, _F, _I, _I, _P],
    # n, m, blocks a pair, resident rows -> clusters the card holds at once
    "aspire_sinkhorn_cluster_capacity": [_I] * 4,
    # q, k, v, bias, out, b, nh, t, the padded head width, q/k/v/out strides
    # (batch, head, token) x4, sm_scale, dropout mode.., 1 - p in the compute
    # dtype, bits, row statistics for the backward (or null), stream
    "aspire_attention_bf16": [_P] * 5 + [_I] * 4 + [_LL] * 12 + [_F] + _DROP + [_F, _P, _P, _P],
    "aspire_attention_f32": [_P] * 5 + [_I] * 4 + [_LL] * 12 + [_F] + _DROP + [_F, _P, _P, _P],
    # q, k, v, bias, g, out, dq, dk, dv, stats, scratch (bf16: ds^T; f32 at
    # heads wider than 64: ds and pd; else null), b, nh, t, the padded head
    # width, 24 strides (q, k, v, g, out, dq, dk, dv), sm_scale, dropout
    # mode.., 1 - p in the compute dtype and in f32, bits, stream
    "aspire_attention_bwd_bf16": [_P] * 11 + [_I] * 4 + [ctypes.POINTER(_LL), _F] + _DROP
                                 + [_F, _F, _P, _P],
    "aspire_attention_bwd_f32": [_P] * 11 + [_I] * 4 + [ctypes.POINTER(_LL), _F] + _DROP
                                + [_F, _F, _P, _P],
    # x, out, bits, rows, h, dropout mode.., scale, stream
    "aspire_dropout_bf16": [_P] * 3 + [_LL, _I] + _DROP + [_F, _P],
    "aspire_dropout_f32": [_P] * 3 + [_LL, _I] + _DROP + [_F, _P],
    # x, w1 [inter, hidden], b1, w2 [hidden, inter], b2, activation scratch,
    # out, rows, hidden, inter, stream
    "aspire_ffn_bf16": [_P] * 7 + [_I] * 3 + [_P],
    # x, w1, b1, w2, b2, TF32 parts of x, w1, w2, parts of the activation,
    # out, rows, hidden, inter, stream
    "aspire_ffn_f32": [_P] * 8 + [_I] * 3 + [_P],
    # hidden, sent_ids, out, b, t, h, max_sents, columns a lane, sentences a
    # block, stream
    "aspire_pool_bf16": [_P] * 3 + [_I] * 6 + [_P],
    "aspire_pool_f32": [_P] * 3 + [_I] * 6 + [_P],
    # sents, (scales,) norms, q, qadd, out, n_docs, S, D, 8-column tiles a
    # group, tiles a query, groups, out's row length, rows a span, stream
    "aspire_scan_bf16": [_P] * 5 + [_I] * 8 + [_P],
    "aspire_scan_int8": [_P] * 6 + [_I] * 8 + [_P],
    # sents, (scales,) norms, q (k permuted), qadd, out, n_docs, S, D, tiles a
    # query, groups of 128 columns, out's row length, rows a span, a group's
    # blocks, stream
    "aspire_scan_int8_wide": [_P] * 6 + [_I] * 8 + [_P],
    "aspire_scan_bf16_wide": [_P] * 5 + [_I] * 8 + [_P],
    # the same as aspire_scan_bf16 without the span (units of 64 documents)
    "aspire_scan_f32": [_P] * 5 + [_I] * 7 + [_P],
}

_lib = None
build_seconds: float | None = None
build_log: str = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of aspire_tpu_torch "
                       "are built from source and need the CUDA toolkit")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def load() -> ctypes.CDLL:
    """The loaded kernel library; builds it on the first call."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"libaspire_kernels_{_digest()}.so"
    # an advisory lock, released when its holder exits however it exits
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not target.exists():
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "--threads", str(len(srcs)),
                   "-o", str(tmp), *map(str, srcs)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_seconds = time.perf_counter() - t0
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n"
                                   + build_log)
            os.replace(tmp, target)
    lib = ctypes.CDLL(str(target))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.aspire_error_string.argtypes = [ctypes.c_int]
    lib.aspire_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise when a launch was refused (too much shared memory, bad grid...)."""
    if err != 0:
        msg = load().aspire_error_string(err).decode()
        raise RuntimeError(f"CUDA launch of {name} failed: {msg} (error {err})")
