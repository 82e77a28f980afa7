"""Philox4x32-10 in plain PyTorch: the dropout bit stream of the port.

The TPU kernels of the JAX package draw their masks from a hardware stream
seeded per grid program, so a mask depends on how the kernel is tiled.  Here
a mask is a function of the element's position, whatever kernel asks for it:

    key     = the call's 64-bit seed (low word, high word)
    counter = (kind << 24 | site, plane, row, column // 4)

``kind`` is 0 for hidden dropout (plane 0) and 1 for attention probabilities
(plane = batch * heads + head), so the two never share a counter even for
equal site numbers.  Plane and row are places in the whole batch: a data
rank that holds rows ``[r0, r0 + n)`` of it draws with its planes offset by
``r0 * heads`` (attention) and its rows by ``r0 * tokens`` (hidden dropout),
so that its masks are those rows of the one-process masks (``plane0``,
``row0``; 0 on one process).  One call gives four 32-bit words; word ``column % 4`` is
the column's.  An element is kept when its word >= round(p * 2**32), compared
unsigned (``keep_threshold``).  ``csrc/common.cuh`` computes the same words on
the card, so the kernels' plain versions reproduce their masks exactly, and a
CPU run and a card run of one seed drop the same elements.

The 32 x 32 -> 64 bit products run in int64 on values below 2**32 (the
product's low 63 bits are exact, the high word is assembled from 16-bit
halves), on the CPU or the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

KIND_HIDDEN = 0
KIND_ATTENTION = 1

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def keep_threshold(dropout_p: float) -> int:
    """uint32 threshold: drop when bits < thresh; P(keep) = 1 - p (+-2^-32)."""
    return int(round(float(dropout_p) * 2.0 ** 32))


def _mulhilo(m: int, x: torch.Tensor):
    """(high, low) 32-bit words of m * x for int64 x in [0, 2^32)."""
    m_lo, m_hi = m & 0xFFFF, m >> 16
    x_lo, x_hi = x & 0xFFFF, x >> 16
    ll = m_lo * x_lo
    mid = m_hi * x_lo + (ll >> 16)          # < 2^32 + 2^16
    mid2 = m_lo * x_hi + (mid & 0xFFFF)
    hi = m_hi * x_hi + (mid >> 16) + (mid2 >> 16)
    lo = ((mid2 & 0xFFFF) << 16) | (ll & 0xFFFF)
    return hi & _MASK, lo


def philox4x32_10(counter, key):
    """counter: four int64 tensors (broadcastable) with values in [0, 2^32);
    key: two ints.  Returns the four output words as int64 tensors."""
    c0, c1, c2, c3 = torch.broadcast_tensors(*counter)
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def counter_word0(kind: int, site: int) -> int:
    if not 0 <= site < (1 << 24):
        raise ValueError(f"site must be in [0, 2^24), got {site}")
    return (int(kind) << 24) | int(site)


def _plane_bits(seed: int, c0: int, planes: int, rows: int, cols: int,
                device, plane0: int = 0, row0: int = 0) -> torch.Tensor:
    """int64 [planes, rows, cols] of uint32 values, planes and rows counted
    from plane0 and row0."""
    if plane0 + planes > 1 << 32 or row0 + rows > 1 << 32:
        raise ValueError("planes and rows are 32-bit counter words")
    groups = -(-cols // 4)
    ar = lambda n, at=0: torch.arange(at, at + n, dtype=torch.int64,
                                      device=device)
    counter = (torch.full((1, 1, 1), c0, dtype=torch.int64, device=device),
               ar(planes, plane0)[:, None, None], ar(rows, row0)[None, :, None],
               ar(groups)[None, None, :])
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    words = philox4x32_10(counter, (seed & _MASK, seed >> 32))
    return torch.stack(words, dim=-1).reshape(planes, rows, groups * 4)[..., :cols]


def hidden_bits(seed: int, site: int, rows: int, cols: int,
                device="cpu", row0: int = 0) -> torch.Tensor:
    """Bits of a [rows, cols] hidden-dropout site whose first row is row0 of
    the whole batch, as int64 holding uint32."""
    return _plane_bits(seed, counter_word0(KIND_HIDDEN, site), 1, rows, cols,
                       device, row0=row0)[0]


def attention_bits(seed: int, site: int, b: int, nh: int, t: int,
                   device="cpu", plane0: int = 0) -> torch.Tensor:
    """Bits of a [b, nh, t, t] attention-probability site whose first plane
    is plane0 of the whole batch (int64 of uint32)."""
    return _plane_bits(seed, counter_word0(KIND_ATTENTION, site), b * nh, t, t,
                       device, plane0=plane0).reshape(b, nh, t, t)


class Seed(NamedTuple):
    """An encode's dropout seed and the place of its first example in the
    whole batch: what a data rank passes where one process passes the bare
    64-bit seed (``models/bert.py`` takes either)."""

    seed: int
    example0: int = 0


def split_seed(seed) -> tuple:
    """(64-bit seed or None, first example's place) of a bare seed or a Seed."""
    if isinstance(seed, Seed):
        return seed.seed, seed.example0
    return seed, 0


def bits_to_int64(bits: torch.Tensor) -> torch.Tensor:
    """Any integer tensor holding uint32 bit patterns (int32, uint32 or int64)
    -> int64 values in [0, 2^32)."""
    if bits.dtype == torch.int64:
        return bits & _MASK
    if bits.dtype == torch.uint32:
        bits = bits.view(torch.int32)
    return bits.to(torch.int64) & _MASK
