"""CUDA fused attention, forward (with or without dropout) and backward:
wrapper, launch counts, plain version.

Replaces the TPU kernels of ``aspire_tpu/ops/pallas_attention.py``
(entry point ``fused_dropout_attention``): ``_fwd_kernel`` built at
``dropout_p=0`` (what ``_select_impl`` calls 'fused_det') and at
``dropout_p>0`` ('fused'), and ``_bwd_kernel``.  The CUDA sources are
``csrc/attention.cu`` and ``csrc/attention_bwd.cu``.  At BERT shapes the
forward's work per byte is low (64-wide heads, t <= 512), so device memory
bounds it: the kernel reads q, k, v once per query tile and writes the context
once, and the [t, t] scores and probabilities never leave the chip.  The
backward keeps q, k, v, bias, the seed, the forward's output and each row's
softmax max and sum, recomputes probabilities and mask, and is bounded by its
products; in bf16 it hands ds from its keys kernel to its dq kernel through a
transient [b * nh, tp, tp] scratch (tp = t rounded up to 64) that lives only
during the backward.

Rounding follows the TPU kernel: scores, max, exp, sum and the division in
f32, the normalised probabilities cast to the compute dtype, then (with
dropout) divided by 1 - p in the compute dtype and the dropped ones zeroed,
then probs.v accumulated in f32.  The mask is keep = bits >= round(p * 2**32)
with bits from the ``rng_bits`` operand or from Philox words keyed on the
element's position (``ops/philox.py``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, philox

HEAD_DIM = 64   # the kernels are built for 64-wide heads


def fused_attention_plain(q, k, v, bias, sm_scale: float,
                          dropout_p: float = 0.0, keep=None) -> torch.Tensor:
    """Plain PyTorch version (the naive path), with an explicit keep mask when
    dropout_p > 0.  Differentiable by ordinary autograd.

    q/k/v: [b, nh, t, hd] compute dtype; bias: [b, t] f32 additive key mask;
    keep: bool [b, nh, t, t].
    """
    dtype = q.dtype
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * sm_scale + bias.float()[:, None, None, :]
    probs = torch.softmax(s, dim=-1).to(dtype)
    if dropout_p > 0.0:
        if keep is None:
            raise ValueError("dropout_p > 0 needs a keep mask")
        div = torch.tensor(1.0 - dropout_p, dtype=dtype, device=q.device)
        probs = torch.where(keep, probs / div, torch.zeros_like(probs))
    return torch.matmul(probs.float(), v.float()).to(dtype)


def attention_keep_mask(shape, dropout_p: float, *, seed=None, site: int = 0,
                        rng_bits=None, device="cpu") -> torch.Tensor:
    """bool [b, nh, t, t]: the mask the kernels apply for q of `shape`."""
    b, nh, t, _ = shape
    thresh = philox.keep_threshold(dropout_p)
    if rng_bits is not None:
        return philox.bits_to_int64(rng_bits).reshape(b, nh, t, t) >= thresh
    return philox.attention_bits(seed, site, b, nh, t, device=device) >= thresh


def _strides(x):
    if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]) \
            or x.data_ptr() % 16:
        raise ValueError("the attention kernel needs unit stride on the head "
                         "dimension and 16-byte aligned rows")
    return x.stride()[:3]


@functools.lru_cache(maxsize=None)
def _kernel_constants(dropout_p: float, dtype: torch.dtype, site: int):
    """(counter word 0, keep threshold, 1 - p rounded to dtype, 1 - p in f32)."""
    return (philox.counter_word0(philox.KIND_ATTENTION, site),
            philox.keep_threshold(dropout_p),
            float(torch.tensor(1.0 - dropout_p, dtype=dtype)),
            float(torch.tensor(1.0 - dropout_p, dtype=torch.float32)))


def _drop_args(q, dropout_p, seed, site, bits):
    """(mode, seed, counter word 0, threshold, 1 - p in q's dtype, 1 - p in
    f32, bits pointer) as the C functions take them."""
    if dropout_p == 0.0:
        return 0, 0, 0, 0, 1.0, 1.0, 0
    c0, thresh, keep_div, keep_div32 = _kernel_constants(dropout_p, q.dtype, site)
    return (1 if bits is None else 2, int(seed or 0) & 0xFFFFFFFFFFFFFFFF,
            c0, thresh, keep_div, keep_div32,
            0 if bits is None else bits.data_ptr())


def _forward_cuda(q, k, v, bias, sm_scale, dropout_p, seed, site, bits,
                  stats=None):
    """stats: None, or the [3, b * nh, t] f32 tensor that receives each row's
    softmax max and sum (planes 0 and 1) for the backward."""
    b, nh, t, _ = q.shape
    out = torch.empty_like(q)          # keeps a dense q's strides
    strides = [*_strides(q), *_strides(k), *_strides(v), *_strides(out)]
    mode, seed, c0, thresh, keep_div, _, bits_ptr = _drop_args(
        q, dropout_p, seed, site, bits)
    lib = _build.load()
    name = ("aspire_attention_bf16" if q.dtype == torch.bfloat16
            else "aspire_attention_f32")
    with torch.cuda.device(q.device):
        err = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, nh, t, *strides, float(sm_scale), mode, seed,
            c0, thresh, keep_div, bits_ptr,
            0 if stats is None else stats.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    if mode == 0:
        fused_attention.launches += 1
    else:
        fused_attention.dropout_launches += 1
    return out


def _backward_cuda(q, k, v, bias, out, stats, g, sm_scale, dropout_p, seed,
                   site, bits):
    """One backward.  bf16: three launches (delta, keys kernel for dk and dv,
    dq kernel), with ds^T handed between the last two through a bf16 scratch
    allocated here and freed on return.  f32: two launches (rows kernel for
    delta and dq, keys kernel for dk and dv).  out and stats are the
    forward's."""
    b, nh, t, _ = q.shape
    try:
        _strides(g)
    except ValueError:
        g = g.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    strides = []
    for x in (q, k, v, g, out, dq, dk, dv):
        strides.extend(_strides(x))
    mode, seed, c0, thresh, keep_div, keep_div32, bits_ptr = _drop_args(
        q, dropout_p, seed, site, bits)
    lib = _build.load()
    bf16 = q.dtype == torch.bfloat16
    name = "aspire_attention_bwd_bf16" if bf16 else "aspire_attention_bwd_f32"
    scratch = []                        # held until the launches are queued
    if bf16:
        tp = -(-t // 64) * 64
        scratch = [torch.empty((b * nh, tp, tp), dtype=torch.bfloat16,
                               device=q.device)]
    with torch.cuda.device(q.device):
        err = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            g.data_ptr(), out.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), stats.data_ptr(),
            *(x.data_ptr() for x in scratch), b, nh, t,
            (ctypes.c_longlong * 24)(*strides),
            float(sm_scale), mode, seed, c0, thresh, keep_div, keep_div32,
            bits_ptr, torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    fused_attention.bwd_launches += 3 if bf16 else 2   # what the C function launches
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """Forward: the kernel without or with dropout.  Backward: the backward
    kernels, from q, k, v, bias, the seed, the forward's output and two
    floats a row (the softmax max and sum); nothing [t, t]-shaped is kept
    between the two (the bf16 backward's ds scratch is its own, transient)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, sm_scale, dropout_p, seed, site, bits):
        b, nh, t, _ = q.shape
        stats = torch.empty((3, b * nh, t), dtype=torch.float32,
                            device=q.device)
        out = _forward_cuda(q, k, v, bias, sm_scale, dropout_p, seed, site,
                            bits, stats)
        ctx.save_for_backward(q, k, v, bias, out, stats)
        ctx.args = (sm_scale, dropout_p, seed, site, bits)
        return out

    @staticmethod
    def backward(ctx, g):
        dq, dk, dv = _backward_cuda(*ctx.saved_tensors, g, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def fused_attention(q, k, v, bias, sm_scale: float, dropout_p: float = 0.0,
                    *, seed: int | None = None, site: int = 0,
                    rng_bits: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q.k^T * sm_scale + bias) [dropout] . v with nothing
    intermediate in device memory, differentiable in q, k, v.

    q, k, v: [b, nh, t, hd] bf16 or f32, any batch/head/token strides (views
    of a [b, t, nh, hd] projection are taken as they are); bias: [b, t] f32
    additive key mask (0 at real tokens, -1e9 at pads; it gets no gradient).
    seed: the call's 64-bit seed as a Python int; site: the layer index;
    rng_bits: optional 32-bit integer [b, nh, t, t] bits drawn by the caller
    (the route by which parity with the JAX package is tested).  Returns
    [b, nh, t, hd] in q's dtype and, for a dense q, q's memory layout.
    CUDA tensors launch the kernels; CPU tensors run the plain version under
    ordinary autograd with the same bits.
    """
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [b, nh, t, hd] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, nh, t, hd = q.shape
    if bias.shape != (b, t):
        raise ValueError(f"bias must be [b, t] = {(b, t)}, got {tuple(bias.shape)}")
    if dropout_p > 0.0:
        if rng_bits is None and seed is None:
            raise ValueError("attention dropout needs a seed or rng_bits")
        if rng_bits is not None and tuple(rng_bits.shape) != (b, nh, t, t):
            raise ValueError(f"rng_bits must be [b, nh, t, t] = "
                             f"{(b, nh, t, t)}, got {tuple(rng_bits.shape)}")
    if not q.is_cuda:
        keep = None
        if dropout_p > 0.0:
            keep = attention_keep_mask(q.shape, dropout_p, seed=seed,
                                       site=site, rng_bits=rng_bits,
                                       device=q.device)
        return fused_attention_plain(q, k, v, bias, sm_scale, dropout_p, keep)
    if hd != HEAD_DIM:
        raise ValueError(f"the attention kernels are built for head width "
                         f"{HEAD_DIM}, got {hd}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError("q, k, v must all be bfloat16 or all float32")
    if not (k.device == v.device == bias.device == q.device):
        raise ValueError("all inputs must lie on the same device")
    bias = bias.detach().float().contiguous()
    bits = None
    if dropout_p > 0.0 and rng_bits is not None:
        if rng_bits.device != q.device or rng_bits.element_size() != 4:
            raise ValueError("rng_bits must be a 32-bit integer tensor on "
                             "q's device")
        bits = rng_bits.contiguous()
    for x in (q, k, v):
        _strides(x)
    args = (q, k, v, bias, float(sm_scale), float(dropout_p), seed, int(site),
            bits)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(*args)
    return _forward_cuda(*args)


# launches of the deterministic forward, of the forward with dropout, and of
# the backward's kernels (three a bf16 backward: delta, keys, dq; two an f32
# one: rows, keys)
fused_attention.launches = 0
fused_attention.dropout_launches = 0
fused_attention.bwd_launches = 0
