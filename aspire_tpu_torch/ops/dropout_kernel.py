"""CUDA hidden dropout with the mask made in the kernel: wrapper, launch count
and plain version.

Replaces the TPU kernel ``aspire_tpu/ops/pallas_dropout.py:_apply_kernel``
(entry point ``hw_dropout``).  The CUDA source is ``csrc/dropout.cu``.  Device
memory bounds it: the forward reads x and writes out, the backward reads the
cotangent and writes dx, and nothing mask-shaped is kept between them -- the
``autograd.Function`` saves the seed and the site (or the ``rng_bits`` tensor
when the caller gave one) and the backward makes the same bits again.

Semantics are ``flax.linen.Dropout``'s up to the bit stream:

    keep = bits >= round(p * 2**32)        (unsigned)
    out  = where(keep, x * (1 / (1 - p) rounded to x's dtype), 0)

The bits are Philox4x32-10 words keyed on (seed, site, row, column), see
``ops/philox.py``; they differ from the JAX package's by design.
"""
from __future__ import annotations

import functools

import torch

from . import _build, philox


@functools.lru_cache(maxsize=None)
def _scale(dropout_p: float, dtype: torch.dtype) -> torch.Tensor:
    """1 / (1 - p) rounded to dtype, a CPU scalar tensor."""
    return torch.tensor(1.0 / (1.0 - dropout_p), dtype=dtype)


@functools.lru_cache(maxsize=None)
def _kernel_constants(dropout_p: float, dtype: torch.dtype, site: int):
    """(counter word 0, keep threshold, scale as a float) of a site."""
    return (philox.counter_word0(philox.KIND_HIDDEN, site),
            philox.keep_threshold(dropout_p), float(_scale(dropout_p, dtype)))


def dropout_plain(x: torch.Tensor, keep: torch.Tensor,
                  dropout_p: float) -> torch.Tensor:
    """Plain PyTorch version with an explicit keep mask (differentiable)."""
    scale = _scale(dropout_p, x.dtype).to(x.device)
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def keep_mask(shape, dropout_p: float, *, seed: int | None = None,
              site: int = 0, rng_bits: torch.Tensor | None = None,
              device="cpu") -> torch.Tensor:
    """The keep mask the kernel applies to a tensor of this shape: from
    `rng_bits` when given, else from the Philox words of (seed, site)."""
    thresh = philox.keep_threshold(dropout_p)
    if rng_bits is not None:
        return philox.bits_to_int64(rng_bits).reshape(tuple(shape)) >= thresh
    h = shape[-1]
    rows = 1
    for d in shape[:-1]:
        rows *= d
    bits = philox.hidden_bits(seed, site, rows, h, device=device)
    return (bits >= thresh).reshape(tuple(shape))


def _launch(x2: torch.Tensor, dropout_p: float, seed: int, site: int,
            bits: torch.Tensor | None) -> torch.Tensor:
    """One pass of the kernel over a contiguous [rows, h] CUDA tensor."""
    rows, h = x2.shape
    vec = 8 if x2.dtype == torch.bfloat16 else 4
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError("the dropout kernel takes bfloat16 or float32")
    if h % vec:
        raise ValueError(f"the dropout kernel moves {vec} elements at a time: "
                         f"the last dimension ({h}) must be a multiple")
    out = torch.empty_like(x2)
    if rows == 0:
        return out
    if bits is not None:
        if bits.device != x2.device or bits.shape != x2.shape \
                or bits.element_size() != 4 or not bits.is_contiguous():
            raise ValueError("rng_bits must be a contiguous 32-bit integer "
                             "tensor of x's shape on x's device")
    lib = _build.load()
    name = ("aspire_dropout_bf16" if x2.dtype == torch.bfloat16
            else "aspire_dropout_f32")
    c0, thresh, scale = _kernel_constants(dropout_p, x2.dtype, site)
    with torch.cuda.device(x2.device):
        err = getattr(lib, name)(
            x2.data_ptr(), out.data_ptr(),
            0 if bits is None else bits.data_ptr(), rows, h,
            1 if bits is None else 2, int(seed or 0) & 0xFFFFFFFFFFFFFFFF,
            c0, thresh, scale, torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, name)
    fused_dropout.launches += 1
    return out


class _Dropout(torch.autograd.Function):
    """Forward and backward are the same masked scale; nothing tensor-shaped
    is saved unless the caller supplied the bits."""

    @staticmethod
    def forward(ctx, x, dropout_p, seed, site, bits):
        ctx.args = (dropout_p, seed, site, bits)
        ctx.shape = x.shape
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        return _launch(x2, dropout_p, seed, site, bits).reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        dropout_p, seed, site, bits = ctx.args
        g2 = g.reshape(-1, g.shape[-1]).contiguous()
        dx = _launch(g2, dropout_p, seed, site, bits).reshape(ctx.shape)
        return dx, None, None, None, None


def fused_dropout(x: torch.Tensor, dropout_p: float, *, seed: int | None = None,
                  site: int = 0, rng_bits: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """Dropout whose mask never touches device memory.

    x:        [..., h] bf16 or f32; flattened to [rows, h].
    seed:     the call's 64-bit seed, a Python int (no device read).  Ignored
              when rng_bits is given.
    site:     per-call-site counter (BERT: 0 embeddings, 1 + 2i and 2 + 2i in
              layer i) so that sites sharing a seed draw distinct masks.
    rng_bits: optional 32-bit integer tensor of x's shape -- bits drawn by the
              caller, the route by which parity with the JAX package is tested.
    Differentiable in x.  p == 0 returns x without a launch.  CUDA tensors
    launch the kernel, CPU tensors run the plain version under autograd.
    """
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    if dropout_p == 0.0:
        return x
    if rng_bits is None and seed is None:
        raise ValueError("fused_dropout needs a seed or rng_bits")
    if rng_bits is not None and tuple(rng_bits.shape) != tuple(x.shape):
        raise ValueError(f"rng_bits must have x's shape {tuple(x.shape)}, got "
                         f"{tuple(rng_bits.shape)}")
    if not x.is_cuda:
        keep = keep_mask(x.shape, dropout_p, seed=seed, site=site,
                         rng_bits=rng_bits, device=x.device)
        return dropout_plain(x, keep, dropout_p)
    bits = None
    if rng_bits is not None:
        bits = rng_bits.reshape(-1, x.shape[-1]).contiguous()
    return _Dropout.apply(x, float(dropout_p), seed, int(site), bits)


fused_dropout.launches = 0
