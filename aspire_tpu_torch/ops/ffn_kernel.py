"""CUDA fused FFN forward: wrapper, launch count and plain version.

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


def fused_ffn(x, w1, b1, w2, b2) -> torch.Tensor:
    """gelu-FFN forward with the intermediate kept on chip.

    x: [..., h] bf16 or f32, flattened to [rows, h]; w1: [h, f], b1: [f],
    w2: [f, h], b2: [h] in the same dtype (the caller casts parameters once).
    Forward only: with grad enabled on inputs that require grad it raises.
    CUDA tensors launch the kernel, CPU tensors run the plain version.
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
        raise NotImplementedError(
            "fused_ffn is forward-only in this slice of the port (the split "
            "autograd.Function comes with the training slice); call it under "
            "torch.inference_mode() or torch.no_grad()")
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
