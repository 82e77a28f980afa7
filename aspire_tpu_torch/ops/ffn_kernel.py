"""CUDA FFN forward: wrapper, launch count, plain version, and the split
between no-grad and grad passes.

Replaces the TPU kernel ``aspire_tpu/ops/pallas_ffn.py:_fwd_kernel`` (the
primal of ``fused_ffn``): ``gelu_erf(x.W1 + b1).W2 + b2``.  The CUDA source is
``csrc/ffn.cu``: two launches of one tiled ``wgmma`` product, the first with
a bias + exact gelu epilogue that writes the activation in x's dtype to a
scratch [rows, inter] tensor allocated here, the second with a bias epilogue.
The two products do far more operations per byte than the card's memory can
feed, so the tensor cores bound it; the scratch (one write and one read of
the activation, rounded where the fused kernel rounds it) is a small share
of the time.  The kernel takes hidden and intermediate widths that are
multiples of 64; other widths are zero-padded here, which is exact (zero x
columns meet zero W1 rows, gelu(0) = 0, zero W2 rows add nothing).

In f32 (the evaluation's encode) the products run on the tensor cores at f32
accuracy as split TF32: one more launch splits x and both weights into TF32
hi and lo parts in a scratch tensor allocated here, launch 1 stores the
activation's two parts (a [2, rows, inter] scratch), and each product sums
lo.hi + hi.lo + hi.hi (``csrc/common.cuh`` says why that holds f32).

The kernel reads the weights K-major, in ``nn.Linear``'s [out, in] layout:
`fused_ffn_linear` takes them so (the model's cached copies), `fused_ffn`
keeps the JAX function's [in, out] signature and transposes.

Under grad the kernel is not used, as in the JAX package
(``pallas_ffn.py`` ``fwd``/``bwd``): the forward is the plain composition,
which rounds the pre-activation to x's dtype (the kernel does not), and the
backward is the standard five products.  Those are plain large products that
the JAX package leaves to XLA, so they go to ``torch.matmul`` here.  gelu and
its derivative use the exact ``erf`` (the JAX package's polynomial differs by
at most 1.5e-7).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

WIDTH_STEP = 64   # the kernel takes widths that are multiples of this


def fused_ffn_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version: f32 pre-activation and exact (erf) gelu, the
    activation cast to x's dtype before the second product, f32 accumulation.

    x: [..., h]; w1: [h, f]; b1: [f]; w2: [f, h]; b2: [h], all in x's dtype.
    """
    pre = torch.matmul(x.float(), w1.float()) + b1.float()
    h = F.gelu(pre, approximate="none").to(x.dtype)
    out = torch.matmul(h.float(), w2.float()) + b2.float()
    return out.to(x.dtype)


class _FfnTrain(torch.autograd.Function):
    """The grad-enabled split: plain composition forward saving (x, pre, w1,
    w2), five-product backward."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        pre = torch.addmm(b1, x, w1)                      # rounded to x's dtype
        # gelu works in f32 inside and rounds once, whatever pre's dtype
        h = F.gelu(pre, approximate="none")
        out = torch.addmm(b2, h, w2)
        ctx.save_for_backward(x, pre, w1, w2)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, pre, w1, w2 = ctx.saved_tensors
        dtype = x.dtype
        h = F.gelu(pre, approximate="none")               # recomputed, not saved
        dy = dy.to(dtype)
        dh = torch.matmul(dy, w2.t())
        # dh * (Phi(pre) + pre * phi(pre)) in f32, rounded once: one
        # elementwise pass instead of a chain of them over [rows, f]
        dpre = torch.ops.aten.gelu_backward(dh, pre, approximate="none")
        dx = torch.matmul(dpre, w1.t())
        dw1 = torch.matmul(x.t(), dpre)
        db1 = dpre.float().sum(dim=0).to(dtype)
        dw2 = torch.matmul(h.t(), dy)
        db2 = dy.float().sum(dim=0).to(dtype)
        return dx, dw1, db1, dw2, db2


def _check(x, w1, b1, w2, b2) -> None:
    """Raises unless x [..., h], w1 [h, f], b1 [f], w2 [f, h], b2 [h]."""
    h, f = w1.shape
    if x.shape[-1] != h or w2.shape != (f, h) or b1.shape != (f,) \
            or b2.shape != (h,):
        raise ValueError(f"shapes do not form an FFN: x {tuple(x.shape)}, "
                         f"w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, "
                         f"w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)}")


def fused_ffn(x, w1, b1, w2, b2) -> torch.Tensor:
    """gelu-FFN: with grad disabled the kernel, with grad enabled the plain
    forward and the five-product backward.

    x: [..., h] bf16 or f32, flattened to [rows, h]; w1: [h, f], b1: [f],
    w2: [f, h], b2: [h] in the same dtype (the caller casts parameters).
    Differentiable in all five.  Without grad, CUDA tensors launch the
    kernel and CPU tensors run its plain version.
    """
    return fused_ffn_linear(x, w1.t(), b1, w2.t(), b2)


def fused_ffn_linear(x, w1, b1, w2, b2) -> torch.Tensor:
    """`fused_ffn` with the weights in nn.Linear's [out, in] layout: w1
    [f, h], w2 [h, f] -- what the kernel reads, so contiguous weights of this
    layout reach it without a copy."""
    _check(x, w1.t(), b1, w2.t(), b2)
    h = x.shape[-1]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        if any(t.dtype != x.dtype for t in (w1, b1, w2, b2)):
            raise TypeError("x and the parameters must share one dtype")
        out = _FfnTrain.apply(x.reshape(-1, h), w1.t(), b1, w2.t(), b2)
        return out.reshape(x.shape)
    if not x.is_cuda:
        return fused_ffn_plain(x, w1.t(), b1, w2.t(), b2)
    if x.dtype not in (torch.bfloat16, torch.float32) or any(
            t.dtype != x.dtype for t in (w1, b1, w2, b2)):
        raise TypeError("x and the parameters must all be bfloat16 or all "
                        "float32")
    if any(t.device != x.device for t in (w1, b1, w2, b2)):
        raise ValueError("all inputs must lie on the same device")
    return _ffn_cuda(x.reshape(-1, h), w1, b1, w2, b2).reshape(x.shape)


def padded_widths(h: int, f: int) -> tuple:
    """The widths the kernel runs at: each rounded up to a multiple of 64."""
    up = lambda n: -(-n // WIDTH_STEP) * WIDTH_STEP
    return up(h), up(f)


def pad_ffn(x, w1, b1, w2, b2):
    """Zero-pads x [rows, h], w1 [f, h], b1, w2 [h, f], b2 to the kernel's
    widths (`padded_widths`); the first h columns of the padded FFN's output
    are the FFN's output, exactly."""
    h, f = x.shape[-1], w1.shape[0]
    hp, fp = padded_widths(h, f)
    if (hp, fp) == (h, f):
        return x, w1, b1, w2, b2
    dh, df = hp - h, fp - f
    return (F.pad(x, (0, dh)), F.pad(w1, (0, dh, 0, df)), F.pad(b1, (0, df)),
            F.pad(w2, (0, df, 0, dh)), F.pad(b2, (0, dh)))


def _ffn_cuda(x2, w1, b1, w2, b2) -> torch.Tensor:
    """The launches on CUDA tensors (`LAUNCHES`): x2 [rows, h], w1 [f, h],
    w2 [h, f]."""
    rows, h = x2.shape
    if rows == 0:
        return torch.empty_like(x2)
    # dense rows from 16-byte boundaries, as TMA and 16-byte loads read them
    x2, w1, b1, w2, b2 = (t if t.data_ptr() % 16 == 0 else t.clone()
                          for t in (u.contiguous() for u in pad_ffn(x2, w1, b1, w2, b2)))
    hp, fp = x2.shape[1], w1.shape[0]
    out = torch.empty((rows, hp), dtype=x2.dtype, device=x2.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        if x2.dtype == torch.bfloat16:
            name = "aspire_ffn_bf16"
            act = torch.empty((rows, fp), dtype=x2.dtype, device=x2.device)
            err = lib.aspire_ffn_bf16(
                x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), act.data_ptr(), out.data_ptr(), rows, hp, fp,
                stream)
        else:
            # the TF32 hi and lo parts of x and both weights, and of the
            # activation (written by the first product, read by the second)
            name = "aspire_ffn_f32"
            parts = torch.empty(2 * (rows + 2 * fp) * hp, dtype=x2.dtype,
                                device=x2.device)
            act = torch.empty((2, rows, fp), dtype=x2.dtype, device=x2.device)
            err = lib.aspire_ffn_f32(
                x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), parts.data_ptr(), act.data_ptr(),
                out.data_ptr(), rows, hp, fp, stream)
    _build.check(err, name)
    fused_ffn.launches += LAUNCHES[x2.dtype]   # what the C function launches
    return out if hp == h else out[:, :h]


# kernel launches: two a bf16 CUDA call (activation, output), three an f32
# one (the split into TF32 parts, activation, output)
LAUNCHES = {torch.bfloat16: 2, torch.float32: 3}
fused_ffn.launches = 0
