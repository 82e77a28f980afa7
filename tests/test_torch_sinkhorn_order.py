"""The Sinkhorn kernel's arithmetic for pairs of up to 32 x 32
(`sinkhorn_small_kernel` in csrc/sinkhorn.cu), written out in numpy float32
and held against the kernel's plain version and the JAX package's Pallas
kernel in interpret mode.

Four threads a softmin: thread (atom, sub) of the row (column) threads holds
the cost of its row (column) at columns (rows) sub, sub + 4, ..., sums its
terms in that order, and the four partial sums meet by two butterfly
shuffles, (s0 + s1) + (s2 + s3) on every thread.  The other side's h lies
lane-major in shared memory (`hpos`), so a thread's values sit side by side.
Exponentials are base 2: h2 = log2(e) * (log-weight + potential / eps), terms
h2 - c * inv2 with inv2 = log2(e) / eps rounded, softmin = -(log2(sum) + max) /
inv2 (`divide=False`: the form before the repair, -eps ln 2 * (log2(sum) +
max), which scales every potential by the rounding of inv2).  numpy has
no fused multiply-add and no ex2.approx, so the model holds the order, not
the last bit: the card's kernel is held against the plain version by
`chip_smoke.py`.
"""
import math

import numpy as np
import pytest
import torch

from aspire_tpu.ops.pallas_sinkhorn import sinkhorn_potentials_pallas
from aspire_tpu_torch.ops import sinkhorn as ts
from aspire_tpu_torch.ops.sinkhorn_kernel import SMALL_SIDE, sinkhorn_solve_plain

from test_torch_sinkhorn import KTOL, _check_mass, _clouds, _j, _t

LANES = 4
F32 = np.float32
LOG2E, LN2 = F32(1.4426950408889634), F32(0.6931471805599453)


def lane_slices(side: int):
    """Thread (atom, sub) -> the indices its registers hold of the other side:
    sub, sub + 4, ... below `side`, ceil(side / 4) slots in all."""
    per = -(-side // LANES)
    return per, [[sub + LANES * k for k in range(per)] for sub in range(LANES)]


def butterfly_sum(parts: np.ndarray) -> np.ndarray:
    """[..., LANES] partial sums -> what `s += shfl_xor(s, w)` for w = 1, 2
    leaves on lane 0 (every lane holds the same: a + b == b + a)."""
    w = 1
    while w < LANES:
        parts = parts + parts[..., np.arange(LANES) ^ w]
        w <<= 1
    return parts[..., 0]


def softmin2(c: np.ndarray, h2: np.ndarray, inv2: np.ndarray, eps: np.ndarray,
             divide: bool = True):
    """c [B, A, K] (K the summed axis), h2 [B, K] -> [B, A] in the kernel's order."""
    bsz, atoms, k_len = c.shape
    per, _ = lane_slices(k_len)
    pad = per * LANES - k_len
    t = (h2[:, None, :] - c * inv2[:, None, None]).astype(F32)
    t = np.concatenate([t, np.full((bsz, atoms, pad), -np.inf, F32)], axis=2)
    t = t.reshape(bsz, atoms, per, LANES)       # index j = k * LANES + sub
    mx = t.max(axis=(2, 3))
    e = np.exp2(t - mx[:, :, None, None]).astype(F32)
    parts = np.zeros((bsz, atoms, LANES), F32)
    for k in range(per):                       # a thread's own terms, in order
        parts = (parts + e[:, :, k, :]).astype(F32)
    s = butterfly_sum(parts)
    lse2 = (np.log2(s) + mx).astype(F32)
    if divide:
        return (-lse2 / inv2[:, None]).astype(F32)
    return ((-eps * LN2)[:, None] * lse2).astype(F32)


def kernel_order_solve(cost, log_a, log_b, diam, blur=0.05, scaling=0.9,
                       max_iters=128, extrapolate=True, divide=True):
    """numpy float32 model of sinkhorn_small_kernel -> (f [B, n], g [B, m]);
    divide=False models the softmin before the repair (module docstring)."""
    cost, log_a, log_b, diam = (np.asarray(v, F32) for v in (cost, log_a, log_b, diam))
    log_s = F32(math.log(scaling))
    ratio = np.log(F32(blur) / np.maximum(diam, F32(1e-30))) / log_s
    lane_iters = np.ceil(np.maximum(ratio, F32(0))) + F32(2)
    iters = np.minimum(lane_iters, F32(max_iters)).astype(np.int64)
    d_floor = np.maximum(diam, F32(1e-12))

    def eps_at(i):
        k = F32(max(i - 1, 0))
        return np.where(i >= lane_iters - 1, F32(blur),
                        d_floor * np.exp(k * log_s).astype(F32)).astype(F32)

    la2, lb2 = (log_a * LOG2E).astype(F32), (log_b * LOG2E).astype(F32)
    cost_t = np.ascontiguousarray(cost.transpose(0, 2, 1))

    def rounds(h_a2, h_b2, eps):
        inv2 = ((F32(1) / eps) * LOG2E).astype(F32)
        return (softmin2(cost, h_b2, inv2, eps, divide),
                softmin2(cost_t, h_a2, inv2, eps, divide))

    f, g = rounds(la2, lb2, eps_at(0))
    for it in range(int(iters.max())):
        eps = eps_at(it)
        inv2 = ((F32(1) / eps) * LOG2E).astype(F32)[:, None]
        ft, gt = rounds((la2 + f * inv2).astype(F32), (lb2 + g * inv2).astype(F32), eps)
        live = (it < iters)[:, None]
        f = np.where(live, (F32(0.5) * (f + ft)).astype(F32), f)
        g = np.where(live, (F32(0.5) * (g + gt)).astype(F32), g)
    if not extrapolate:
        return f, g
    blur32 = np.full_like(diam, F32(blur))
    if not divide:
        return rounds((la2 + (f / F32(blur)) * LOG2E).astype(F32),
                      (lb2 + (g / F32(blur)) * LOG2E).astype(F32), blur32)
    inv2 = (F32(1) / F32(blur)) * LOG2E        # the factor the final softmins take
    return rounds((la2 + f * inv2).astype(F32), (lb2 + g * inv2).astype(F32), blur32)


def hpos(j: int) -> int:
    """Where atom j's h lies in its side's buffer (the kernel's `hpos`)."""
    slots = SMALL_SIDE // LANES
    return (j % LANES) * slots + j // LANES


@pytest.mark.parametrize("n,m", [(1, 1), (4, 4), (20, 20), (3, 13), (32, 5), (32, 32)])
def test_each_cost_entry_is_held_once_an_orientation(n, m):
    side = max(n, m)
    per, slices = lane_slices(side)
    assert per <= SMALL_SIDE // LANES
    threads = -(-2 * LANES * side // 32) * 32    # rows, then columns; whole warps
    assert threads <= 2 * LANES * SMALL_SIDE      # the kernel's launch bound
    for other in (n, m):
        held = [j for sl in slices for j in sl if j < other]
        assert sorted(held) == list(range(other))
    # the lane-major layout: a permutation, each thread's atoms side by side
    assert sorted(hpos(j) for j in range(SMALL_SIDE)) == list(range(SMALL_SIDE))
    for sub, sl in enumerate(slices):
        assert [hpos(j) for j in sl] == list(range(sub * (SMALL_SIDE // LANES),
                                                   sub * (SMALL_SIDE // LANES) + per))


def _inputs(rng, **shape):
    a, x, b, y = _clouds(rng, **shape)
    cost = ts.pairwise_l2(*_t(x, y))
    la, lb = ts.log_weights(torch.from_numpy(a)), ts.log_weights(torch.from_numpy(b))
    diam = ts.resolve_diameter(*_t(x, y, a, b), "pair", None)
    return (a, x, b, y), (cost, la, lb, diam)


@pytest.mark.parametrize("extrapolate", [True, False], ids=["extrapolated", "loop_only"])
@pytest.mark.parametrize("shape", [dict(bsz=6, n=20, m=20), dict(bsz=4, n=3, m=13),
                                   dict(bsz=3, n=32, m=32, d=8), dict(bsz=3, n=5, m=4)],
                         ids=["20x20", "3x13", "32x32", "5x4"])
def test_kernel_order_matches_the_plain_version(rng, shape, extrapolate):
    (a, _, b, _), args = _inputs(rng, **shape)
    f, g = kernel_order_solve(*(v.numpy() for v in args), extrapolate=extrapolate)
    fp, gp = sinkhorn_solve_plain(*args, extrapolate=extrapolate)
    _check_mass(f, fp, a, KTOL)
    _check_mass(g, gp, b, KTOL)


def test_kernel_order_matches_pallas_interpret(rng):
    (a, x, b, y), args = _inputs(rng, bsz=5, n=20, m=17)
    f, g = kernel_order_solve(*(v.numpy() for v in args))
    fj, gj = sinkhorn_potentials_pallas(*_j(a, x, b, y), diameter="pair", interpret=True)
    _check_mass(f, fj, a, KTOL)
    _check_mass(g, gj, b, KTOL)
