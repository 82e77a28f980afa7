"""CUDA sentence pooling: wrapper, launch count and plain version.

Replaces the TPU kernel ``aspire_tpu/ops/pallas_pool.py:_pool_kernel`` (entry
point ``sentence_pool_pallas``): per-sentence token sums of the final hidden
states, f32, added in token order; the counts and the division are plain
tensor code outside, as on the TPU.  The CUDA source is ``csrc/pool.cu``: a
block owns one example and 128 columns, keeps a [max_sents, 128] f32 tile in
shared memory and walks the tokens once, so the one-hot [S, T] matrix of the
plain version is never formed.  Device memory bounds it -- one read of
``hidden``, one write of [b, max_sents, h] -- and at the encode shape that is
a few microseconds, so the launch and the serial walk over t are most of its
time.

The kernel has no backward (neither has the TPU kernel): `sentence_pool`
takes it only where no gradient is wanted.
"""
from __future__ import annotations

import torch

from . import _build

MAX_SHARED_BYTES = 48 * 1024     # [max_sents, 128] f32 tile + t ids


def _one_hot(sent_ids: torch.Tensor, max_sents: int) -> torch.Tensor:
    sents = torch.arange(max_sents, device=sent_ids.device)[None, None, :]
    return (sent_ids[:, :, None] == sents).float()              # [b, t, s]


def sentence_pool_plain(hidden: torch.Tensor, sent_ids: torch.Tensor,
                        max_sents: int) -> torch.Tensor:
    """Plain PyTorch version: one one-hot segment-mean product (differentiable
    in `hidden`).  Same arguments and result as `sentence_pool_fused`."""
    one_hot = _one_hot(sent_ids, max_sents)
    sums = torch.matmul(one_hot.transpose(1, 2), hidden.float())
    counts = torch.clamp_min(one_hot.sum(dim=1), 1.0)
    return sums / counts[:, :, None]


def sentence_sums(hidden: torch.Tensor, sent_ids: torch.Tensor,
                  max_sents: int) -> torch.Tensor:
    """The kernel alone: f32[b, max_sents, h] token sums per sentence of a
    CUDA `hidden` [b, t, h] (bf16 or f32, h even) under int `sent_ids` [b, t];
    ids outside [0, max_sents) add nowhere."""
    if not hidden.is_cuda:
        raise ValueError("sentence_sums launches the CUDA kernel: hidden must "
                         "be a CUDA tensor")
    if hidden.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"hidden must be bfloat16 or float32, got {hidden.dtype}")
    if hidden.ndim != 3 or sent_ids.shape != hidden.shape[:2]:
        raise ValueError(f"hidden [b, t, h] and sent_ids [b, t] expected, got "
                         f"{tuple(hidden.shape)} and {tuple(sent_ids.shape)}")
    if sent_ids.device != hidden.device:
        raise ValueError("hidden and sent_ids must lie on the same device")
    b, t, h = hidden.shape
    if h % 2 or max_sents < 1 \
            or max_sents * 128 * 4 + t * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"the pooling kernel takes an even width and a "
                         f"[max_sents, 128] f32 tile plus t ids within "
                         f"{MAX_SHARED_BYTES} bytes, got h={h}, "
                         f"max_sents={max_sents}, t={t}")
    out = torch.empty((b, max_sents, h), dtype=torch.float32,
                      device=hidden.device)
    if b == 0 or t == 0:
        return out.zero_()
    x = hidden.detach().contiguous()
    ids = sent_ids.to(torch.int32).contiguous()
    lib = _build.load()
    name = "aspire_pool_bf16" if x.dtype == torch.bfloat16 else "aspire_pool_f32"
    with torch.cuda.device(x.device):
        err = getattr(lib, name)(
            x.data_ptr(), ids.data_ptr(), out.data_ptr(), b, t, h, max_sents,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    sentence_pool_fused.launches += 1
    return out


def sentence_pool_fused(hidden: torch.Tensor, sent_ids: torch.Tensor,
                        max_sents: int) -> torch.Tensor:
    """Mean-pool token states into per-sentence vectors, without gradients.

    hidden: [b, t, h]; sent_ids: int[b, t] (-1 outside sentences).  Returns
    f32[b, max_sents, h]; a sentence with no tokens gives a zero vector.  CUDA
    tensors launch the kernel (or raise), CPU tensors run the plain version.
    """
    if not hidden.is_cuda:
        return sentence_pool_plain(hidden.detach(), sent_ids, max_sents)
    sums = sentence_sums(hidden, sent_ids, max_sents)
    # t * s work, next to nothing beside the t * s * h of the sums
    counts = torch.clamp_min(_one_hot(sent_ids, max_sents).sum(dim=1), 1.0)
    return sums / counts[:, :, None]


sentence_pool_fused.launches = 0
