"""CUDA fused attention (deterministic forward): wrapper, count, plain version.

Replaces the TPU kernel ``aspire_tpu/ops/pallas_attention.py:_fwd_kernel``
built at ``dropout_p=0`` (entry point ``fused_dropout_attention``, what
``_select_impl`` calls 'fused_det').  The CUDA source is ``csrc/attention.cu``.
At BERT shapes the work per byte is low (64-wide heads, t <= 512), so device
memory bounds it: the kernel reads q, k, v once per query tile and writes the
context once, and the [t, t] scores and probabilities never leave the chip.
Rounding follows the TPU kernel: scores, max, exp, sum and the division in
f32, the normalised probabilities cast to the compute dtype, then probs.v
accumulated in f32 -- done in two passes over the keys (row statistics first,
then probabilities and context) so that no rescaling after the cast is needed.
"""
from __future__ import annotations

import torch

from . import _build

HEAD_DIM = 64   # the kernel is built for 64-wide heads


def fused_attention_plain(q, k, v, bias, sm_scale: float) -> torch.Tensor:
    """Plain PyTorch version (the naive path with every key kept).

    q/k/v: [b, nh, t, hd] compute dtype; bias: [b, t] f32 additive key mask.
    """
    dtype = q.dtype
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * sm_scale + bias.float()[:, None, None, :]
    probs = torch.softmax(s, dim=-1).to(dtype)
    return torch.matmul(probs.float(), v.float()).to(dtype)


def _strides(x):
    if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]) \
            or x.data_ptr() % 16:
        raise ValueError("the attention kernel needs unit stride on the head "
                         "dimension and 16-byte aligned rows")
    return x.stride()[:3]


def fused_attention(q, k, v, bias, sm_scale: float,
                    dropout_p: float = 0.0) -> torch.Tensor:
    """softmax(q.k^T * sm_scale + bias) . v with nothing intermediate in
    device memory.

    q, k, v: [b, nh, t, hd] bf16 or f32, any batch/head/token strides (views
    of a [b, t, nh, hd] projection are taken as they are); bias: [b, t] f32
    additive key mask (0 at real tokens, -1e9 at pads).  Returns
    [b, nh, t, hd] in q's dtype and, for a dense q, q's memory layout.
    CUDA tensors launch the kernel, CPU tensors run the plain version.
    """
    if dropout_p > 0.0:
        raise NotImplementedError(
            "attention with in-kernel dropout (and its backward) belongs to "
            "the training slice of the port; this kernel is the "
            "deterministic forward")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [b, nh, t, hd] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, nh, t, hd = q.shape
    if bias.shape != (b, t):
        raise ValueError(f"bias must be [b, t] = {(b, t)}, got {tuple(bias.shape)}")
    if not q.is_cuda:
        return fused_attention_plain(q, k, v, bias, sm_scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "the attention backward kernel belongs to the training slice of "
            "the port; call under torch.inference_mode() or torch.no_grad()")
    if hd != HEAD_DIM:
        raise ValueError(f"the attention kernel is built for head width "
                         f"{HEAD_DIM}, got {hd}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError("q, k, v must all be bfloat16 or all float32")
    if not (k.device == v.device == bias.device == q.device):
        raise ValueError("all inputs must lie on the same device")
    bias = bias.float().contiguous()
    out = torch.empty_like(q)          # keeps a dense q's strides
    strides = [*_strides(q), *_strides(k), *_strides(v), *_strides(out)]
    lib = _build.load()
    name = ("aspire_attention_bf16" if q.dtype == torch.bfloat16
            else "aspire_attention_f32")
    with torch.cuda.device(q.device):
        err = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, nh, t, *strides, float(sm_scale),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
