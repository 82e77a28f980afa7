"""The f32 training attention (csrc/attention.cu attention_tf32x3_stats_kernel,
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


def _pad(x, tp, value=0.0):
    return F.pad(x, (0, 0, 0, tp - x.shape[-2]), value=value)


def _keep_factors(p):
    """1 / (1 - p) in f32, as the kernels take it (one reciprocal a call)."""
    keep_div = torch.tensor(1.0 - p, dtype=torch.float32)
    return float(torch.tensor(1.0, dtype=torch.float32) / keep_div)


def forward_two_walks(q, k, v, bias, scale, p, keep):
    """ctx, the row statistics m and l, and the probabilities of pass 2 ([b,
    nh, t, tp]), as attention_tf32x3_stats_kernel computes them."""
    b, nh, t, _ = q.shape
    tp = -(-t // TILE) * TILE
    kp, vp = _pad(k, tp), _pad(v, tp)
    bias_p = F.pad(bias, (0, tp - t), value=-math.inf)
    keep_p = None if keep is None else F.pad(keep, (0, tp - t), value=True)
    inv_keep = _keep_factors(p) if p > 0 else None

    def scores(k0):                 # the shared score tile: split q.k^T, scaled, biased
        return (matmul_3xtf32(q, kp[..., k0:k0 + TILE, :].transpose(-1, -2)) * scale
                + bias_p[:, None, None, k0:k0 + TILE])

    m = torch.full((b, nh, t), -math.inf)
    l = torch.zeros((b, nh, t))
    for k0 in range(0, tp, TILE):   # pass 1
        s = scores(k0)
        m_new = torch.maximum(m, s.amax(-1))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(-1)
        m = m_new
    inv_l = 1.0 / l
    ctx = torch.zeros_like(q)
    probs = torch.empty((b, nh, t, tp))
    for k0 in range(0, tp, TILE):   # pass 2
        pt = torch.exp(scores(k0) - m[..., None]) * inv_l[..., None]
        probs[..., k0:k0 + TILE] = pt
        if keep_p is not None:
            pt = torch.where(keep_p[..., k0:k0 + TILE], pt * inv_keep, 0.0)
        for c in range(k0, k0 + TILE, STEP):   # a fresh accumulator a k-step
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


def _inputs(p, t):
    q, k, v, g, bias, bits = _case(t, seed=100 + t + int(p * 10))
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
