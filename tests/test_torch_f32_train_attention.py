"""The f32 training attention (csrc/attention.cu attention_tf32x3_walk_kernel,
csrc/attention_bwd.cu bwd_rows_tf32x3_kernel and bwd_keys_tf32x3_kernel),
written out in plain PyTorch on the CPU: the arithmetic of the kernels that
`train --no-bf16-compute` runs, held against the JAX package's
fused_dropout_attention (Pallas kernel in interpret mode, forward and its
vjp) and against autograd of the port's plain version, on the same numpy
inputs with the dropout bits given as rng_bits.

Every product is split TF32 (`matmul_3xtf32` of test_torch_f32_split.py: the
cross terms, then hi.hi).  The forward walks 64-key tiles twice: pass 1 the
online max m and sum l of each row, pass 2 the same scores again, p = exp(s -
m) * (1 / l), pd = keep ? p * (1 / (1 - p_drop)) : 0 and ctx += pd . v a
k-step of 8 keys at a time; m and l are what it leaves for the backward.  The
backward is two kernels: the rows kernel takes delta = rowsum(g * ctx), recomputes each key
tile's scores with the forward's score tile, dpd = g . v^T, ds = p (dprobs -
delta) scale and sums dq = ds . k a k-step of 8 keys at a time; the keys kernel
walks 64-row query tiles with the tile transposed (S^T = k . q^T, dpd^T = v .
g^T) and sums dv = pd^T . g and dk = ds^T . q 8 rows at a time.  Rows and keys
past t are zero-padded, with a -inf key bias and (m, 1 / l, delta) = (0, 1, 0).

Heads wider than 64 (96 padded to 128, 128, 192, 256) run the same forward at
their width with the key tiles their kernel takes (WIDE_TILES), and another
backward: a scores kernel walks the key tiles of its own size for 64 query
rows, recomputes each tile's probabilities with the forward's score tile and
writes ds and pd (zero in rows past t) to a [tp, tp] scratch, keys past t
included; a gradients kernel sums dq = ds . k, dk = ds^T . q and dv = pd^T . g
from it, a k-step of 8 at a time (`backward_scratch`, `backward_grads`).

float32 atol 1e-5 (the existing decomposition tests' tolerance): other
summation orders, the split products (about 2^-22 of each product) and exp
routines.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from aspire_tpu.ops.pallas_attention import fused_dropout_attention
from aspire_tpu_torch.ops.attention_kernel import (attention_keep_mask,
                                                   fused_attention,
                                                   fused_attention_plain)
from test_torch_attention_bwd_tiles import _case
from test_torch_f32_split import matmul_3xtf32

TILE, STEP = 64, 8
TOL = dict(atol=1e-5, rtol=0.0)
CASES = [(p, t) for p in (0.0, 0.1) for t in (64, 200)]
# padded head width -> (the forward's key tile, the backward scores kernel's)
WIDE_TILES = {128: (32, 64), 192: (16, 32), 256: (16, 16)}
WIDE_CASES = [(hd, p) for hd in (96, 128, 192, 256) for p in (0.0, 0.1)]
WIDE_T = 200


def _pad(x, tp, value=0.0):
    return F.pad(x, (0, 0, 0, tp - x.shape[-2]), value=value)


def _keep_factors(p):
    """1 / (1 - p) in f32, as the kernels take it (one reciprocal a call)."""
    keep_div = torch.tensor(1.0 - p, dtype=torch.float32)
    return float(torch.tensor(1.0, dtype=torch.float32) / keep_div)


def forward_two_walks(q, k, v, bias, scale, p, keep, tile=TILE):
    """ctx, the row statistics m and l, and the probabilities of pass 2 ([b,
    nh, t, tp]), as attention_tf32x3_walk_kernel computes them on key tiles
    of `tile`."""
    b, nh, t, _ = q.shape
    tp = -(-t // tile) * tile
    kp, vp = _pad(k, tp), _pad(v, tp)
    bias_p = F.pad(bias, (0, tp - t), value=-math.inf)
    keep_p = None if keep is None else F.pad(keep, (0, tp - t), value=True)
    inv_keep = _keep_factors(p) if p > 0 else None

    def scores(k0):                 # the shared score tile: split q.k^T, scaled, biased
        return (matmul_3xtf32(q, kp[..., k0:k0 + tile, :].transpose(-1, -2)) * scale
                + bias_p[:, None, None, k0:k0 + tile])

    m = torch.full((b, nh, t), -math.inf)
    l = torch.zeros((b, nh, t))
    for k0 in range(0, tp, tile):   # pass 1
        s = scores(k0)
        m_new = torch.maximum(m, s.amax(-1))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(-1)
        m = m_new
    inv_l = 1.0 / l
    ctx = torch.zeros_like(q)
    probs = torch.empty((b, nh, t, tp))
    for k0 in range(0, tp, tile):   # pass 2
        pt = torch.exp(scores(k0) - m[..., None]) * inv_l[..., None]
        probs[..., k0:k0 + tile] = pt
        if keep_p is not None:
            pt = torch.where(keep_p[..., k0:k0 + tile], pt * inv_keep, 0.0)
        for c in range(k0, k0 + tile, STEP):   # a fresh accumulator a k-step
            ctx = ctx + matmul_3xtf32(pt[..., c - k0:c - k0 + STEP], vp[..., c:c + STEP, :])
    return ctx, m, l, probs


def _row_stats(m, l, delta, tp):
    """(m, 1 / l, delta) padded to tp rows with (0, 1, 0)."""
    pad = lambda x, value: _pad(x[..., None], tp, value)[..., 0]
    return pad(m, 0.0), pad(1.0 / l, 1.0), pad(delta, 0.0)


def backward_rows(q, k, v, bias, g, ctx, m, l, scale, p, keep):
    """dq, delta and the recomputed probabilities, as bwd_rows_tf32x3_kernel."""
    b, nh, t, hd = q.shape
    tp = -(-t // TILE) * TILE
    kp, vp = _pad(k, tp), _pad(v, tp)
    bias_p = F.pad(bias, (0, tp - t), value=-math.inf)
    keep_p = None if keep is None else F.pad(keep, (0, tp - t), value=True)
    delta = (g * ctx).sum(-1)
    inv_l = 1.0 / l
    dq = torch.zeros((b, nh, t, hd))
    probs = torch.empty((b, nh, t, tp))
    for k0 in range(0, tp, TILE):
        kt, vt = kp[..., k0:k0 + TILE, :], vp[..., k0:k0 + TILE, :]
        s = (matmul_3xtf32(q, kt.transpose(-1, -2)) * scale
             + bias_p[:, None, None, k0:k0 + TILE])
        pt = torch.exp(s - m[..., None]) * inv_l[..., None]
        probs[..., k0:k0 + TILE] = pt
        dprobs = matmul_3xtf32(g, vt.transpose(-1, -2))
        if keep_p is not None:
            dprobs = torch.where(keep_p[..., k0:k0 + TILE], dprobs * _keep_factors(p), 0.0)
        ds = (pt * (dprobs - delta[..., None])) * scale
        for c in range(0, TILE, STEP):   # a fresh accumulator a k-step, added in f32
            dq = dq + matmul_3xtf32(ds[..., c:c + STEP], kt[..., c:c + STEP, :])
    return dq, delta, probs


def backward_keys(q, k, v, bias, g, m, l, delta, scale, p, keep):
    """dk and dv, as bwd_keys_tf32x3_kernel: each 64-row query tile
    transposed, the sums over rows a k-step of 8 rows at a time."""
    b, nh, t, hd = q.shape
    tp = -(-t // TILE) * TILE
    qp, gp = _pad(q, tp), _pad(g, tp)
    m_p, inv_l_p, delta_p = _row_stats(m, l, delta, tp)
    key_bias = bias[:, None, :, None]             # keys are the rows of S^T
    keep_t = None if keep is None else F.pad(keep, (0, 0, 0, tp - t),
                                             value=True).transpose(-1, -2)
    dk = torch.zeros((b, nh, t, hd))
    dv = torch.zeros((b, nh, t, hd))
    for q0 in range(0, tp, TILE):
        rows = slice(q0, q0 + TILE)
        qt, gt = qp[..., rows, :], gp[..., rows, :]
        s_t = matmul_3xtf32(k, qt.transpose(-1, -2)) * scale + key_bias
        pt = torch.exp(s_t - m_p[..., None, rows]) * inv_l_p[..., None, rows]
        dprobs = matmul_3xtf32(v, gt.transpose(-1, -2))
        pd = pt
        if keep_t is not None:
            kt = keep_t[..., rows]
            pd = torch.where(kt, pt * _keep_factors(p), 0.0)
            dprobs = torch.where(kt, dprobs * _keep_factors(p), 0.0)
        ds = (pt * (dprobs - delta_p[..., None, rows])) * scale
        for c in range(0, TILE, STEP):
            dv = dv + matmul_3xtf32(pd[..., c:c + STEP], gt[..., c:c + STEP, :])
            dk = dk + matmul_3xtf32(ds[..., c:c + STEP], qt[..., c:c + STEP, :])
    return dk, dv


def backward_scratch(q, k, v, bias, g, ctx, m, l, scale, p, keep, tile):
    """ds and pd [b, nh, tp, tp] (tp = t rounded up to 64; zero in rows past
    t) and the recomputed probabilities of the rows below t, as
    bwd_scores_f32_kernel writes them, walking key tiles of `tile` up to tp."""
    b, nh, t, _ = q.shape
    tp = -(-t // 64) * 64
    qp, kp, vp, gp = (_pad(x, tp) for x in (q, k, v, g))
    bias_p = F.pad(bias, (0, tp - t), value=-math.inf)
    keep_p = None if keep is None else F.pad(keep, (0, tp - t, 0, tp - t), value=True)
    m_p, inv_l_p, delta_p = _row_stats(m, l, (g * ctx).sum(-1), tp)
    real = (torch.arange(tp) < t)[:, None]
    ds = torch.empty((b, nh, tp, tp))
    pd = torch.empty((b, nh, tp, tp))
    for k0 in range(0, tp, tile):
        cols = slice(k0, k0 + tile)
        s = (matmul_3xtf32(qp, kp[..., cols, :].transpose(-1, -2)) * scale
             + bias_p[:, None, None, cols])
        pt = torch.exp(s - m_p[..., None]) * inv_l_p[..., None]
        dprobs = matmul_3xtf32(gp, vp[..., cols, :].transpose(-1, -2))
        pdt = pt
        if keep_p is not None:
            pdt = torch.where(keep_p[..., cols], pt * _keep_factors(p), 0.0)
            dprobs = torch.where(keep_p[..., cols], dprobs * _keep_factors(p), 0.0)
        ds[..., cols] = (pt * (dprobs - delta_p[..., None])) * scale
        pd[..., cols] = torch.where(real, pdt, 0.0)
        if k0 == 0:
            probs = torch.empty((b, nh, t, tp))
        probs[..., cols] = pt[..., :t, :]
    return ds, pd, probs


def backward_grads(ds, pd, q, k, g):
    """dq = ds . k, dk = ds^T . q, dv = pd^T . g from the scratch, as
    bwd_grads_f32_kernel sums them: a k-step of 8 of the contraction at a
    time, each in a fresh accumulator added in f32."""
    t, tp = q.shape[-2], ds.shape[-1]
    qp, kp, gp = (_pad(x, tp) for x in (q, k, g))
    dq, dk, dv = (torch.zeros_like(qp) for _ in range(3))
    for j in range(0, tp, STEP):
        rows = slice(j, j + STEP)
        dq = dq + matmul_3xtf32(ds[..., :, rows], kp[..., rows, :])
        dk = dk + matmul_3xtf32(ds[..., rows, :].transpose(-1, -2), qp[..., rows, :])
        dv = dv + matmul_3xtf32(pd[..., rows, :].transpose(-1, -2), gp[..., rows, :])
    return dq[..., :t, :], dk[..., :t, :], dv[..., :t, :]


def _inputs(p, t, hd=64):
    q, k, v, g, bias, bits = _case(t, seed=100 + t + int(p * 10) + hd - 64, hd=hd)
    tq, tk, tv, tg, tb = (torch.from_numpy(a) for a in (q, k, v, g, bias))
    keep = attention_keep_mask(tq.shape, p, rng_bits=torch.from_numpy(
        bits.view(np.int32))) if p > 0 else None
    return (q, k, v, g, bias, bits), (tq, tk, tv, tg, tb), keep


def _jax_attention(arrs, p, scale):
    q, k, v, _, bias, bits = arrs

    def out(qj, kj, vj):
        return fused_dropout_attention(
            qj, kj, vj, jnp.asarray(bias), jnp.zeros((1,), jnp.uint32),
            dropout_p=p, sm_scale=float(scale),
            rng_bits=jnp.asarray(bits) if p > 0 else None, interpret=True)

    return jax.vjp(out, *(jnp.asarray(a) for a in (q, k, v)))


@pytest.mark.parametrize("p,t", CASES)
def test_forward_two_walks(p, t):
    """ctx against the Pallas forward and the plain version; m and l are the
    rows' softmax max and sum (the plain version's, rows of the fully padded
    batch included)."""
    arrs, (tq, tk, tv, _, tb), keep = _inputs(p, t)
    scale = 1.0 / math.sqrt(tq.shape[-1])
    ctx, m, l, _ = forward_two_walks(tq, tk, tv, tb, scale, p, keep)
    want_jax, _ = _jax_attention(arrs, p, scale)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(want_jax, np.float32), **TOL,
                               err_msg="against the Pallas forward")
    np.testing.assert_allclose(ctx.numpy(), fused_attention_plain(
        tq, tk, tv, tb, scale, p, keep).numpy(), **TOL, err_msg="against the plain version")
    s = tq @ tk.transpose(-1, -2) * scale + tb[:, None, None, :]
    torch.testing.assert_close(m, s.amax(-1), atol=1e-5, rtol=0)
    torch.testing.assert_close(l, torch.exp(s - s.amax(-1, keepdim=True)).sum(-1),
                               atol=0, rtol=1e-5)


@pytest.mark.parametrize("p,t", CASES)
def test_backward_from_the_statistics(p, t):
    """dq, dk, dv from q, k, v, bias, the bits, the forward's ctx and its m
    and l, against the Pallas backward (the vjp of its forward) and autograd
    of the plain version."""
    arrs, (tq, tk, tv, tg, tb), keep = _inputs(p, t)
    scale = 1.0 / math.sqrt(tq.shape[-1])
    ctx, m, l, _ = forward_two_walks(tq, tk, tv, tb, scale, p, keep)
    dq, delta, _ = backward_rows(tq, tk, tv, tb, tg, ctx, m, l, scale, p, keep)
    dk, dv = backward_keys(tq, tk, tv, tb, tg, m, l, delta, scale, p, keep)
    _, vjp = _jax_attention(arrs, p, scale)
    want_jax = vjp(jnp.asarray(arrs[3]))
    leaves = [x.detach().clone().requires_grad_(True) for x in (tq, tk, tv)]
    fused_attention_plain(*leaves, tb, scale, p, keep).backward(tg)
    for name, got, wj, leaf in zip(("dq", "dk", "dv"), (dq, dk, dv), want_jax, leaves):
        assert bool(torch.isfinite(got).all()), name
        np.testing.assert_allclose(got.numpy(), np.asarray(wj, np.float32), **TOL,
                                   err_msg=f"{name} against the Pallas backward")
        np.testing.assert_allclose(got.numpy(), leaf.grad.numpy(), **TOL,
                                   err_msg=f"{name} against autograd of the plain version")


@pytest.mark.parametrize("p,t", CASES)
def test_recomputed_probabilities_are_the_forwards(p, t):
    """The rows kernel recomputes each probability from the forward's m and
    l with the forward's score tile and arithmetic: the two are equal bit for
    bit (what keeps delta = rowsum(g * ctx) consistent with the backward's
    ds in rows that one key dominates).  The one-walk forward's weights, e
    rescaled tile after tile and divided by l at the end, are not."""
    _, (tq, tk, tv, tg, tb), keep = _inputs(p, t)
    scale = 1.0 / math.sqrt(tq.shape[-1])
    ctx, m, l, fwd_probs = forward_two_walks(tq, tk, tv, tb, scale, p, keep)
    _, _, bwd_probs = backward_rows(tq, tk, tv, tb, tg, ctx, m, l, scale, p, keep)
    assert torch.equal(fwd_probs.view(torch.int32), bwd_probs.view(torch.int32))
    # the one-walk weights of the first key tile, rescaled by each later tile
    s0 = fwd_probs[..., :TILE]
    if t > TILE:
        tp = fwd_probs.shape[-1]
        kp = _pad(tk, tp)
        bias_p = F.pad(tb, (0, tp - t), value=-math.inf)
        m_run, e0 = None, None
        for k0 in range(0, tp, TILE):
            s = (matmul_3xtf32(tq, kp[..., k0:k0 + TILE, :].transpose(-1, -2)) * scale
                 + bias_p[:, None, None, k0:k0 + TILE])
            if m_run is None:
                m_run = s.amax(-1)
                e0 = torch.exp(s - m_run[..., None])
            else:
                m_new = torch.maximum(m_run, s.amax(-1))
                e0 = e0 * torch.exp(m_run - m_new)[..., None]
                m_run = m_new
        one_walk = e0 / l[..., None]
        assert not torch.equal(one_walk, s0)
        torch.testing.assert_close(one_walk, s0, atol=1e-7, rtol=1e-5)


def test_cpu_tensors_count_no_f32_launch():
    """On CPU tensors the wrapper runs its plain version: the f32 counters
    of the kernels do not move."""
    _, (tq, tk, tv, tg, tb), _ = _inputs(0.1, 64)
    before = (fused_attention.f32_dropout_launches, fused_attention.f32_bwd_launches)
    tq.requires_grad_(True)
    fused_attention(tq, tk, tv, tb, 0.125, 0.1, seed=3, site=1).backward(tg)
    assert tq.grad is not None and bool(torch.isfinite(tq.grad).all())
    assert before == (fused_attention.f32_dropout_launches,
                      fused_attention.f32_bwd_launches)


def _wide(p, hd):
    """The inputs at the head's padded width (zero columns past hd), the
    unpadded arrays for the JAX package, the mask, the scale of width hd and
    the kernels' two key tiles."""
    arrs, tens, keep = _inputs(p, WIDE_T, hd)
    width = -(-hd // 64) * 64
    padded = [F.pad(x, (0, width - hd)) for x in tens[:4]] + [tens[4]]
    return arrs, padded, keep, 1.0 / math.sqrt(hd), WIDE_TILES[width]


@pytest.mark.parametrize("hd,p", WIDE_CASES)
def test_forward_two_walks_wide(hd, p):
    """The two walks at the head's width and key tile: ctx (its first hd
    columns; the padded ones zero) against the Pallas forward at width hd
    and the plain version; m and l the rows' softmax max and sum."""
    arrs, (tq, tk, tv, _, tb), keep, scale, (tile, _) = _wide(p, hd)
    ctx, m, l, _ = forward_two_walks(tq, tk, tv, tb, scale, p, keep, tile)
    want_jax, _ = _jax_attention(arrs, p, scale)
    np.testing.assert_allclose(ctx[..., :hd].numpy(), np.asarray(want_jax, np.float32),
                               **TOL, err_msg="against the Pallas forward")
    np.testing.assert_allclose(ctx.numpy(), fused_attention_plain(
        tq, tk, tv, tb, scale, p, keep).numpy(), **TOL, err_msg="against the plain version")
    assert not bool(ctx[..., hd:].any())
    s = tq @ tk.transpose(-1, -2) * scale + tb[:, None, None, :]
    torch.testing.assert_close(m, s.amax(-1), atol=1e-5, rtol=0)
    torch.testing.assert_close(l, torch.exp(s - s.amax(-1, keepdim=True)).sum(-1),
                               atol=0, rtol=1e-5)


@pytest.mark.parametrize("hd,p", WIDE_CASES)
def test_backward_through_the_scratch_wide(hd, p):
    """dq, dk, dv through the ds and pd scratch at the head's width, from the
    forward's ctx, m and l, against the Pallas backward at width hd and
    autograd of the plain version; ds and pd are zero in the scratch's rows
    and keys past t."""
    arrs, (tq, tk, tv, tg, tb), keep, scale, (tile_f, tile_b) = _wide(p, hd)
    ctx, m, l, _ = forward_two_walks(tq, tk, tv, tb, scale, p, keep, tile_f)
    ds, pd, _ = backward_scratch(tq, tk, tv, tb, tg, ctx, m, l, scale, p, keep, tile_b)
    assert not bool(ds[..., WIDE_T:, :].any() or pd[..., WIDE_T:, :].any())
    assert not bool(ds[..., WIDE_T:].any() or pd[..., WIDE_T:].any())
    got = backward_grads(ds, pd, tq, tk, tg)
    _, vjp = _jax_attention(arrs, p, scale)
    want_jax = vjp(jnp.asarray(arrs[3]))
    leaves = [x.detach().clone().requires_grad_(True) for x in (tq, tk, tv)]
    fused_attention_plain(*leaves, tb, scale, p, keep).backward(tg)
    for name, x, wj, leaf in zip(("dq", "dk", "dv"), got, want_jax, leaves):
        assert bool(torch.isfinite(x).all()), name
        np.testing.assert_allclose(x[..., :hd].numpy(), np.asarray(wj, np.float32), **TOL,
                                   err_msg=f"{name} against the Pallas backward")
        np.testing.assert_allclose(x.numpy(), leaf.grad.numpy(), **TOL,
                                   err_msg=f"{name} against autograd of the plain version")


@pytest.mark.parametrize("hd,p", WIDE_CASES)
def test_recomputed_probabilities_are_the_forwards_wide(hd, p):
    """The scores kernel's key tiles are not the forward's at 128 and 192 (64
    against 32, 32 against 16; 16 both at 256), and it walks the keys up to
    t rounded to 64 where the forward stops at the last tile with a key;
    its probabilities, from the forward's m and l and the same score tile,
    are the forward's bit for bit all the same."""
    _, (tq, tk, tv, tg, tb), keep, scale, (tile_f, tile_b) = _wide(p, hd)
    ctx, m, l, fwd_probs = forward_two_walks(tq, tk, tv, tb, scale, p, keep, tile_f)
    _, _, bwd_probs = backward_scratch(tq, tk, tv, tb, tg, ctx, m, l, scale, p, keep, tile_b)
    width = fwd_probs.shape[-1]
    assert torch.equal(fwd_probs.view(torch.int32), bwd_probs[..., :width].view(torch.int32))
    assert not bool(bwd_probs[..., width:].any())
