"""CUDA fused attention, forward (with or without dropout) and backward:
wrapper, launch counts, plain version.

Replaces the TPU kernels of ``aspire_tpu/ops/pallas_attention.py``
(entry point ``fused_dropout_attention``): ``_fwd_kernel`` built at
``dropout_p=0`` (what ``_select_impl`` calls 'fused_det') and at
``dropout_p>0`` ('fused'), and ``_bwd_kernel``.  The CUDA sources are
``csrc/attention.cu`` and ``csrc/attention_bwd.cu``.  The [t, t] scores and
probabilities never leave the chip.  The bf16 forward walks the keys twice
(each row's softmax max and sum, then the probabilities and the context), 128
query rows a block, its two products on wgmma fed by a cp.async ring of key and
value tiles; at BERT shapes (64-wide heads, t <= 512) the elementwise work of
the 2 t^2 scores a head (two exponentials each, with dropout a quarter of a
Philox4x32-10 call) and the latency of each step's loads and products bound it,
not the bytes.  f32 runs both products on the tensor cores as split-TF32
(3xTF32) products at f32 accuracy: the forward without dropout and without a
gradient (the evaluation's encode) walks the keys once with an online
softmax; a forward with dropout or under grad (training with
``--no-bf16-compute``) walks them twice, so that the backward recomputes its
probabilities bit for bit.  Called on
inputs that need a gradient, the forward leaves each row's max and sum in a
[3, b * nh, t] f32 tensor.  The backward keeps q, k, v, bias, the
seed, the forward's output and those two floats a row, recomputes
probabilities and mask, and is bounded by its products; in bf16 it hands ds
from its keys kernel to its dq kernel through a transient [b * nh, tp, tp]
scratch (tp = t rounded up to 64) that lives only during the backward; in f32
a rows kernel (delta, dq) and a keys kernel (dk, dv) each recompute scores and
dpd on the tensor cores.

Rounding follows the TPU kernel: scores, max, exp and sum in f32, the
normalised probabilities cast to the compute dtype, then (with dropout)
divided by 1 - p in the compute dtype and the dropped ones zeroed, then
probs.v accumulated in f32.  The bf16 kernels normalise as exp(s - m) * (1 / l)
and divide as bf16(p) * (1 / bf16(1 - p)), each reciprocal taken once (a row,
a call): the backward recomputes the forward's pd with the same arithmetic,
and the second product is the bf16 quotient exactly.  The f32 kernels
normalise the same way and multiply a kept probability by 1 / (1 - p), an f32
ulp from the division.  The mask is keep = bits
>= round(p * 2**32) with bits from the ``rng_bits`` operand or from Philox
words keyed on the element's position (``ops/philox.py``).

Heads narrower than 64 (``BertConfig.tiny()`` has 8) are zero-padded to 64
columns on the way in and the output sliced back (`with_padded_heads`).  Heads
wider than 64, up to 256, are padded to the next multiple of 64
(`head_route`) and run the same C functions at that width (128, 192, 256), the
tile set by the width's shared memory and registers: in bf16 every product on
wgmma, the backward handing dq and dk to one kernel that reads ds^T from the
scratch; in f32 every product split TF32 on mma.sync as at 64, the forward's
walks instantiated at the width, the backward a scores kernel (ds and pd into
an f32 [2, b * nh, tp, tp] scratch, transient like the bf16 one) and a
gradients kernel (dq, dk, dv from it).  Their launches are counted apart, bf16
(``wide_launches``, ``wide_dropout_launches``, ``wide_bwd_launches``) and f32
(``f32_wide_launches``, ``f32_wide_dropout_launches``,
``f32_wide_bwd_launches``).  Wider heads are refused on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build, philox

HEAD_DIM = 64   # the kernels are built for 64-wide heads; narrower ones are padded
WIDE_MAX = 256  # the wide kernels take heads padded to 128, 192 or 256


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
                        rng_bits=None, device="cpu",
                        plane0: int = 0) -> torch.Tensor:
    """bool [b, nh, t, t]: the mask the kernels apply for q of `shape`, its
    planes counted from plane0."""
    b, nh, t, _ = shape
    thresh = philox.keep_threshold(dropout_p)
    if rng_bits is not None:
        return philox.bits_to_int64(rng_bits).reshape(b, nh, t, t) >= thresh
    return philox.attention_bits(seed, site, b, nh, t, device=device,
                                 plane0=plane0) >= thresh


def head_route(hd: int) -> tuple:
    """(padded width, 'narrow' or 'wide') of a head of width hd on the card:
    up to 64 the 64-wide kernels, above it the kernels of attention.cu and
    attention_bwd.cu instantiated at the next multiple of 64, up to WIDE_MAX;
    wider heads raise."""
    if 1 <= hd <= HEAD_DIM:
        return HEAD_DIM, "narrow"
    if HEAD_DIM < hd <= WIDE_MAX:
        return -(-hd // 64) * 64, "wide"
    raise ValueError(f"the attention kernels take head widths 1 to {WIDE_MAX}, "
                     f"got {hd}")


def with_padded_heads(fn, q, k, v, *args, **kwargs):
    """fn(q, k, v, *args) at the padded head width of `head_route` for q, k,
    v of another width: the three are zero-padded to it and the output is
    sliced back.  Exact, forward and backward: zero columns add nothing to
    q.k^T (the caller's sm_scale passes through), give zero context columns,
    and the cotangent's padded columns are zero, so delta = rowsum(g * ctx)
    and the gradients of the real columns do not change; the dropout mask is
    keyed on (row, key) and does not see the width."""
    hd = q.shape[-1]
    width = head_route(hd)[0]
    if hd == width:
        return fn(q, k, v, *args, **kwargs)
    padded = [F.pad(x, (0, width - hd)) for x in (q, k, v)]
    return fn(*padded, *args, **kwargs)[..., :hd]


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


def _drop_args(q, dropout_p, seed, site, bits, plane0):
    """(mode, seed, counter word 0, threshold, first plane, 1 - p in q's
    dtype, 1 - p in f32, bits pointer) as the C functions take them."""
    if dropout_p == 0.0:
        return 0, 0, 0, 0, 0, 1.0, 1.0, 0
    c0, thresh, keep_div, keep_div32 = _kernel_constants(dropout_p, q.dtype, site)
    return (1 if bits is None else 2, int(seed or 0) & 0xFFFFFFFFFFFFFFFF,
            c0, thresh, plane0, keep_div, keep_div32,
            0 if bits is None else bits.data_ptr())


def _forward_cuda(q, k, v, bias, sm_scale, dropout_p, seed, site, bits,
                  plane0, stats=None):
    """stats: None, or the [3, b * nh, t] f32 tensor that receives each row's
    softmax max and sum (planes 0 and 1) for the backward."""
    b, nh, t, hd = q.shape
    out = torch.empty_like(q)          # keeps a dense q's strides
    strides = [*_strides(q), *_strides(k), *_strides(v), *_strides(out)]
    mode, seed, c0, thresh, plane0, keep_div, _, bits_ptr = _drop_args(
        q, dropout_p, seed, site, bits, plane0)
    lib = _build.load()
    # every width, csrc/attention.cu
    name = "aspire_attention_bf16" if q.dtype == torch.bfloat16 \
        else "aspire_attention_f32"
    with torch.cuda.device(q.device):
        err = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, nh, t, hd, *strides, float(sm_scale), mode, seed,
            c0, thresh, plane0, keep_div, bits_ptr,
            0 if stats is None else stats.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    _count("launches" if mode == 0 else "dropout_launches", q.dtype, hd)
    return out


def _count(kind: str, dtype, hd: int, n: int = 1) -> None:
    """Adds n to the counter of `kind` (launches, dropout_launches,
    bwd_launches) for the dtype and width: 64-wide bf16 under the plain name
    (the deterministic forward of either dtype too), 64-wide f32 with an
    ``f32_`` prefix, wider heads with ``wide_`` (bf16) or ``f32_wide_``."""
    f32 = dtype == torch.float32
    if hd > HEAD_DIM:
        name = ("f32_wide_" if f32 else "wide_") + kind
    elif f32 and kind != "launches":
        name = "f32_" + kind
    else:
        name = kind
    setattr(fused_attention, name, getattr(fused_attention, name) + n)


def _backward_cuda(q, k, v, bias, out, stats, g, sm_scale, dropout_p, seed,
                   site, bits, plane0):
    """One backward.  bf16: three launches (delta, keys kernel for dk and dv,
    dq kernel; at heads wider than 64 delta, keys kernel for dv, one kernel
    for dq and dk), with ds^T handed between the last two through a bf16
    scratch allocated here and freed on return.  f32: two launches (rows
    kernel for delta and dq, keys kernel for dk and dv; at heads wider than
    64 a scores kernel for ds and pd, a gradients kernel for dq, dk and dv,
    the two handed over through an f32 scratch allocated here and freed on
    return).  out and stats are the forward's."""
    b, nh, t, hd = q.shape
    try:
        _strides(g)
    except ValueError:
        g = g.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    strides = []
    for x in (q, k, v, g, out, dq, dk, dv):
        strides.extend(_strides(x))
    mode, seed, c0, thresh, plane0, keep_div, keep_div32, bits_ptr = \
        _drop_args(q, dropout_p, seed, site, bits, plane0)
    lib = _build.load()
    bf16 = q.dtype == torch.bfloat16
    # every width, csrc/attention_bwd.cu; the scratch is held until the
    # launches are queued
    name = "aspire_attention_bwd_bf16" if bf16 else "aspire_attention_bwd_f32"
    tp = -(-t // 64) * 64
    scratch = None
    if bf16:                            # ds^T
        scratch = torch.empty((b * nh, tp, tp), dtype=torch.bfloat16,
                              device=q.device)
    elif hd > HEAD_DIM:                 # ds, then pd
        scratch = torch.empty((2, b * nh, tp, tp), dtype=torch.float32,
                              device=q.device)
    with torch.cuda.device(q.device):
        err = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            g.data_ptr(), out.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), stats.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), b, nh, t, hd,
            (ctypes.c_longlong * 24)(*strides),
            float(sm_scale), mode, seed, c0, thresh, plane0, keep_div,
            keep_div32, bits_ptr, torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    _count("bwd_launches", q.dtype, hd, 3 if bf16 else 2)   # what it launches
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """Forward: the kernel without or with dropout.  Backward: the backward
    kernels, from q, k, v, bias, the seed, the forward's output and two
    floats a row (the softmax max and sum); nothing [t, t]-shaped is kept
    between the two (the bf16 backward's ds scratch is its own, transient)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, sm_scale, dropout_p, seed, site, bits,
                plane0):
        b, nh, t, _ = q.shape
        stats = torch.empty((3, b * nh, t), dtype=torch.float32,
                            device=q.device)
        out = _forward_cuda(q, k, v, bias, sm_scale, dropout_p, seed, site,
                            bits, plane0, stats)
        ctx.save_for_backward(q, k, v, bias, out, stats)
        ctx.args = (sm_scale, dropout_p, seed, site, bits, plane0)
        return out

    @staticmethod
    def backward(ctx, g):
        dq, dk, dv = _backward_cuda(*ctx.saved_tensors, g, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None


def fused_attention(q, k, v, bias, sm_scale: float, dropout_p: float = 0.0,
                    *, seed: int | None = None, site: int = 0,
                    rng_bits: torch.Tensor | None = None,
                    plane0: int = 0) -> torch.Tensor:
    """softmax(q.k^T * sm_scale + bias) [dropout] . v with nothing
    intermediate in device memory, differentiable in q, k, v.

    q, k, v: [b, nh, t, hd] bf16 or f32, hd <= 256 on a CUDA tensor (any hd
    on the CPU), any batch/head/token strides (views of a [b, t, nh, hd]
    projection are taken as they are; other widths than 64, 128, 192 and
    256 are padded, see `head_route` and `with_padded_heads`); bias: [b, t] f32
    additive key mask (0 at real tokens, -1e9 at pads; it gets no gradient).
    seed: the call's 64-bit seed as a Python int; site: the layer index;
    rng_bits: optional 32-bit integer [b, nh, t, t] bits drawn by the caller
    (the route by which parity with the JAX package is tested); plane0: the
    place of plane 0 (example 0, head 0) in the whole batch, a data rank's
    first example times nh, so that the ranks of a data-parallel step drop
    what one process would (ignored with rng_bits).  Returns
    [b, nh, t, hd] in q's dtype and, for a dense q of a kernel's width,
    q's memory layout.
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
                                       device=q.device, plane0=plane0)
        return fused_attention_plain(q, k, v, bias, sm_scale, dropout_p, keep)
    head_route(hd)                      # raises past WIDE_MAX
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
    return with_padded_heads(_attention_cuda, q, k, v, bias, float(sm_scale),
                             float(dropout_p), seed, int(site), bits,
                             int(plane0))


def _attention_cuda(q, k, v, *args):
    """The kernels on [b, nh, t, width] CUDA tensors: through the autograd
    Function when a gradient is wanted, else the forward alone."""
    for x in (q, k, v):
        _strides(x)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, *args)
    return _forward_cuda(q, k, v, *args)


# launches of the deterministic forward (either dtype), of the forward with
# dropout and of the backward's kernels, bf16 (three a backward: delta, keys,
# dq) and f32 (two: rows, keys) apart; then those of the wide kernels (heads
# above 64), bf16 (a backward three: delta, keys, ds) and f32 (a backward two:
# scores, grads) apart (`_count`)
fused_attention.launches = 0
fused_attention.dropout_launches = 0
fused_attention.bwd_launches = 0
fused_attention.f32_dropout_launches = 0
fused_attention.f32_bwd_launches = 0
fused_attention.wide_launches = 0
fused_attention.wide_dropout_launches = 0
fused_attention.wide_bwd_launches = 0
fused_attention.f32_wide_launches = 0
fused_attention.f32_wide_dropout_launches = 0
fused_attention.f32_wide_bwd_launches = 0
