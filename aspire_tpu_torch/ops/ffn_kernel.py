"""CUDA fused FFN forward: wrapper, launch count, plain version, and the
split between no-grad and grad passes.

Replaces the TPU kernel ``aspire_tpu/ops/pallas_ffn.py:_fwd_kernel`` (the
primal of ``fused_ffn``): ``gelu_erf(x.W1 + b1).W2 + b2`` with the
[rows, inter] intermediate never written to device memory.  The CUDA source
is ``csrc/ffn.cu``.  The two products do far more operations per byte than
the card's memory can feed, so the tensor cores bound it.  A block owns 32
rows and all output columns (the f32 accumulator lives in registers) and
walks the intermediate axis in chunks of 64: first product, bias, exact
gelu in f32, cast to the compute dtype, second product.  The weights are
re-read by every row block, are served from the L2 cache, and reach shared
memory through a ring of asynchronous copies kept in flight by two warps that
do nothing else.

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

HIDDEN = 768      # the kernel keeps a [32, HIDDEN] accumulator in registers
INTER_CHUNK = 64


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


def fused_ffn(x, w1, b1, w2, b2) -> torch.Tensor:
    """gelu-FFN: with grad disabled the kernel (intermediate kept on chip),
    with grad enabled the plain forward and the five-product backward.

    x: [..., h] bf16 or f32, flattened to [rows, h]; w1: [h, f], b1: [f],
    w2: [f, h], b2: [h] in the same dtype (the caller casts parameters).
    Differentiable in all five.  Without grad, CUDA tensors launch the
    kernel and CPU tensors run its plain version.
    """
    h = x.shape[-1]
    f = w1.shape[1]
    if w1.shape != (h, f) or w2.shape != (f, h) or b1.shape != (f,) \
            or b2.shape != (h,):
        raise ValueError(f"shapes do not form an FFN: x {tuple(x.shape)}, "
                         f"w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, "
                         f"w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        if any(t.dtype != x.dtype for t in (w1, b1, w2, b2)):
            raise TypeError("x and the parameters must share one dtype")
        out = _FfnTrain.apply(x.reshape(-1, h), w1, b1, w2, b2)
        return out.reshape(x.shape)
    if not x.is_cuda:
        return fused_ffn_plain(x, w1, b1, w2, b2)
    if h != HIDDEN or f % INTER_CHUNK:
        raise ValueError(f"the FFN kernel is built for hidden width {HIDDEN} "
                         f"and an intermediate width divisible by "
                         f"{INTER_CHUNK}, got {h} and {f}")
    if x.dtype not in (torch.bfloat16, torch.float32) or any(
            t.dtype != x.dtype for t in (w1, b1, w2, b2)):
        raise TypeError("x and the parameters must all be bfloat16 or all "
                        "float32")
    if any(t.device != x.device for t in (w1, b1, w2, b2)):
        raise ValueError("all inputs must lie on the same device")
    shape = x.shape
    x2 = x.reshape(-1, h).contiguous()
    w1, b1, w2, b2 = (t.contiguous() for t in (w1, b1, w2, b2))
    rows = x2.shape[0]
    out = torch.empty_like(x2)
    if rows == 0:
        return out.reshape(shape)
    lib = _build.load()
    name = "aspire_ffn_bf16" if x.dtype == torch.bfloat16 else "aspire_ffn_f32"
    with torch.cuda.device(x.device):
        err = getattr(lib, name)(
            x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), rows, h, f,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    fused_ffn.launches += 1
    return out.reshape(shape)


fused_ffn.launches = 0
