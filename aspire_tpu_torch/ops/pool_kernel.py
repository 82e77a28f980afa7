"""CUDA sentence pooling: wrapper, launch count and plain version.

Replaces the TPU kernel ``aspire_tpu/ops/pallas_pool.py:_pool_kernel`` (entry
point ``sentence_pool_pallas``): per-sentence token sums of the final hidden
states in f32; the counts and the division are plain tensor code outside, as on
the TPU.  The CUDA source is ``csrc/pool.cu``: a block owns one example, a
slice of columns and a tile of sentences; its four warps take four contiguous
chunks of the tokens, keep the sum of the current run of equal ids in
registers and add it into a per-warp partial in shared memory when the id
changes; the partials are merged in warp order.  The one-hot [S, T] matrix of
the plain version is never formed.  Device memory bounds it -- one read of
``hidden``, one write of [b, max_sents, h] -- so the design keeps 16 tokens of
16-byte loads in flight a warp.  `launch_plan` picks the load width and the
sentence tile; sentences past one tile take more blocks, so every (t,
max_sents) is taken.  The order of the f32 additions is the one
``csrc/pool.cu``'s header states (tokens in order within a chunk, chunks
merged in order); `tests/test_torch_pool_order.py` models it.

The kernel has no backward (neither has the TPU kernel): `sentence_pool`
takes it only where no gradient is wanted.
"""
from __future__ import annotations

import torch

from . import _build

WARPS = 4                        # token chunks a block, merged in this order
TILE_BYTES = 115200              # the partials of a block: two blocks an SM


def launch_plan(h: int, max_sents: int, element_size: int,
                aligned: bool = True) -> tuple[int, int, int]:
    """(columns a lane loads, sentences a block, sentence tiles) of the
    kernel's launch: 16-byte loads where the width and the pointer allow
    (8 bf16 or 4 f32 columns), else 2 columns; as many sentences a block as
    WARPS f32 partials of [sentences, 32 * vec] fit in TILE_BYTES, spread
    evenly over the tiles."""
    wide = 16 // element_size
    vec = wide if aligned and h % wide == 0 else 2
    cap = max(1, TILE_BYTES // (WARPS * 32 * vec * 4))
    tiles = -(-max_sents // cap)
    return vec, -(-max_sents // tiles), tiles


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
    if h % 2 or max_sents < 1:
        raise ValueError(f"the pooling kernel takes an even width and at least "
                         f"one sentence, got h={h}, max_sents={max_sents}")
    out = torch.empty((b, max_sents, h), dtype=torch.float32,
                      device=hidden.device)
    if b == 0 or t == 0:
        return out.zero_()
    x = hidden.detach().contiguous()
    ids = sent_ids.to(torch.int32).contiguous()
    vec, stile, _ = launch_plan(h, max_sents, x.element_size(),
                                x.data_ptr() % 16 == 0)
    lib = _build.load()
    name = "aspire_pool_bf16" if x.dtype == torch.bfloat16 else "aspire_pool_f32"
    with torch.cuda.device(x.device):
        err = getattr(lib, name)(
            x.data_ptr(), ids.data_ptr(), out.data_ptr(), b, t, h, max_sents,
            vec, stile, torch.cuda.current_stream().cuda_stream)
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
