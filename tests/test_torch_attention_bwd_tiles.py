"""The bf16 attention backward's decomposition (csrc/attention_bwd.cu), written
out in plain PyTorch, against the JAX package's fused_dropout_attention
backward (Pallas kernel in interpret mode, explicit bits) and against autograd
of the port's plain version, on the same numpy inputs.

The decomposition is the CUDA kernels' order of work: a delta pass
(rowsum(g * ctx) over the forward's output), a walk over 64-key tiles that
computes each tile's transposed scores and g.v^T once, draws its mask once and
gives dv, dk and the tile's ds^T into a scratch of [b, nh, tp, tp] (tp = t
rounded up to 64; keys and rows past t are zero-padded with a -inf key bias
and (m, 1/l, delta) = (0, 1, 0)), then dq = ds . k from the scratch.  Its
rounding is the kernels': probs in f32 with 1/l taken once a row, pd =
bf16(probs) * 1/bf16(1 - p), dprobs = dpd * 1/(1 - p) in f32, ds cast to the
compute dtype once for dk and dq alike.

float32 atol 1e-5: another summation order and exp routine.  bfloat16 atol
2e-2 + 2e-2 relative: gradients are sums of up to t products rounded to bf16
once on each side at other places (autograd of the plain version rounds the
probabilities' cotangent to bf16; the JAX kernel keeps pd and ds in f32 until
its products).
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.ops.pallas_attention import fused_dropout_attention
from aspire_tpu_torch.ops.attention_kernel import (attention_keep_mask,
                                                   fused_attention_plain)

B, NH, HD, TILE = 2, 2, 64, 64
DTYPES = {"float32": (jnp.float32, torch.float32, dict(atol=1e-5, rtol=0.0)),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, dict(atol=2e-2, rtol=2e-2))}


def _case(t, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, NH, t, HD)).astype(np.float32)
                  for _ in range(4))
    keep = np.ones((B, t), bool)
    keep[0, t - t // 3:] = False        # padded keys
    keep[1, :] = False                  # a fully padded row: uniform probs
    bias = np.where(keep, 0.0, -1e9).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, (B, NH, t, t), dtype=np.uint32)
    return q, k, v, g, bias, bits


def _pad_rows(x, tp, value=0.0):
    return torch.nn.functional.pad(x, (0, 0, 0, tp - x.shape[-2]), value=value)


def decomposed_backward(q, k, v, bias, g, ctx, scale, p, keep):
    """dq, dk, dv and the ds^T scratch, in the order of the CUDA kernels."""
    dtype, f = q.dtype, torch.float32
    b, nh, t, _ = q.shape
    tp = -(-t // TILE) * TILE
    # the forward's row statistics (planes 0 and 1 of the kernels' stats)
    s = q.to(f) @ k.to(f).transpose(-1, -2) * scale + bias[:, None, None, :]
    m = s.amax(-1)
    l = torch.exp(s - m[..., None]).sum(-1)
    # the delta pass
    delta = (g.to(f) * ctx.to(f)).sum(-1)
    # padding past t: zero rows, (m, 1/l, delta) = (0, 1, 0), key bias -inf
    qp, gp, kp, vp = (_pad_rows(x.to(f), tp) for x in (q, g, k, v))
    m, delta = _pad_rows(m[..., None], tp)[..., 0], _pad_rows(delta[..., None], tp)[..., 0]
    inv_l = _pad_rows((1.0 / l)[..., None], tp, 1.0)[..., 0]
    bias_p = torch.nn.functional.pad(bias, (0, tp - t), value=-math.inf)
    keep_p = None
    if p > 0:
        keep_p = torch.nn.functional.pad(keep, (0, tp - t, 0, tp - t), value=True)
        inv_keep = 1.0 / float(torch.tensor(1.0 - p, dtype=dtype))
        inv_keep32 = float(torch.tensor(1.0, dtype=f) / torch.tensor(1.0 - p, dtype=f))
    # the keys kernel: one 64-key tile at a time, all query rows
    scratch = torch.empty((b, nh, tp, tp), dtype=dtype)
    dk, dv = torch.empty((b, nh, tp, HD), dtype=dtype), torch.empty((b, nh, tp, HD), dtype=dtype)
    for k0 in range(0, tp, TILE):
        ks, vs = kp[..., k0:k0 + TILE, :], vp[..., k0:k0 + TILE, :]
        s_t = ks @ qp.transpose(-1, -2) * scale + bias_p[:, None, k0:k0 + TILE, None]
        probs = torch.exp(s_t - m[..., None, :]) * inv_l[..., None, :]
        dprobs = vs @ gp.transpose(-1, -2)
        pd = probs
        if p > 0:
            keep_t = keep_p[..., k0:k0 + TILE].transpose(-1, -2)
            dprobs = torch.where(keep_t, dprobs * inv_keep32, 0.0)
            pd = torch.where(keep_t, probs.to(dtype).to(f) * inv_keep, 0.0)
        ds = ((probs * (dprobs - delta[..., None, :])) * scale).to(dtype)
        dv[..., k0:k0 + TILE, :] = (pd.to(dtype).to(f) @ gp).to(dtype)
        dk[..., k0:k0 + TILE, :] = (ds.to(f) @ qp).to(dtype)
        scratch[..., k0:k0 + TILE, :] = ds
    # the dq kernel: dq = ds . k over the scratch, 64 query rows at a time
    dq = torch.empty((b, nh, tp, HD), dtype=dtype)
    for q0 in range(0, tp, TILE):
        dq[..., q0:q0 + TILE, :] = (
            scratch[..., q0:q0 + TILE].transpose(-1, -2).to(f) @ kp).to(dtype)
    return dq[..., :t, :], dk[..., :t, :], dv[..., :t, :], scratch


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("p", [0.1, 0.0])
@pytest.mark.parametrize("t", [128, 200])
def test_decomposition_matches_pallas_and_autograd(dtype, p, t):
    jd, td, tol = DTYPES[dtype]
    q, k, v, g, bias, bits = _case(t, seed=t + int(p * 10))
    scale = 1.0 / math.sqrt(HD)
    tq, tk, tv, tg = (torch.from_numpy(a).to(td) for a in (q, k, v, g))
    tb = torch.from_numpy(bias)
    keep = attention_keep_mask(tq.shape, p, rng_bits=torch.from_numpy(
        bits.view(np.int32))) if p > 0 else None
    ctx = fused_attention_plain(tq, tk, tv, tb, scale, p, keep)
    got = decomposed_backward(tq, tk, tv, tb, tg, ctx, scale, p, keep)

    # the scratch past t holds zeros: the dq kernel reads whole tiles
    scratch = got[3].float()
    assert torch.isfinite(scratch).all()
    assert not scratch[..., t:, :].any() and not scratch[..., :, t:].any()

    def jax_out(qj, kj, vj):
        return fused_dropout_attention(
            qj, kj, vj, jnp.asarray(bias), jnp.zeros((1,), jnp.uint32),
            dropout_p=p, sm_scale=float(scale),
            rng_bits=jnp.asarray(bits) if p > 0 else None, interpret=True)

    _, vjp = jax.vjp(jax_out, *(jnp.asarray(a, jd) for a in (q, k, v)))
    want_jax = vjp(jnp.asarray(g, jd))

    leaves = [x.detach().clone().requires_grad_(True) for x in (tq, tk, tv)]
    fused_attention_plain(*leaves, tb, scale, p, keep).backward(tg)

    for name, a_, wj, leaf in zip(("dq", "dk", "dv"), got[:3], want_jax, leaves):
        a_ = a_.float().numpy()
        np.testing.assert_allclose(a_, np.asarray(wj, np.float32), **tol,
                                   err_msg=f"{name} against the Pallas backward")
        np.testing.assert_allclose(a_, leaf.grad.float().numpy(), **tol,
                                   err_msg=f"{name} against autograd of the plain version")
