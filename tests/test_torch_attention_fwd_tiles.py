"""The bf16 attention forward's decomposition (csrc/attention.cu), written out
in plain PyTorch, against the JAX package's fused_dropout_attention forward
(Pallas kernel in interpret mode, explicit bits) and against the port's plain
version, on the same numpy inputs.

The decomposition is the CUDA kernel's order of work: pass 1 walks 64-key
tiles for each row's max m and sum l (online: l = l * exp(m - m') + the tile's
sum of exp(s - m'); keys past t get a -inf bias), pass 2 walks them again for
p = exp(s - m) * (1 / l) in f32, the reciprocal taken once a row, then pd =
bf16(p) * 1/bf16(1 - p) where kept (1/bf16(1 - p) taken once a call), cast to
the compute dtype, and ctx accumulated over the tiles in f32 and cast at the
end.  That pd is the one the backward's keys kernel recomputes from the m and
l the forward leaves behind: the decomposition's pd must equal the backward
decomposition's (tests/test_torch_attention_bwd_tiles.py) bit for bit.

The kernel is one template over the head width: heads of 128 and 256 (the
wide ones, padded there by the wrapper) walk the same two passes, at 256 with
32-key tiles (`key_tile`), so the wide tests hold the decomposition at those
tile sizes.

float32 atol 1e-5: another summation order and exp routine.  bfloat16 atol
2e-2 + 2e-2 relative, the tolerances of the backward's tile test: the context
is rounded to bf16 once on each side, and the probabilities at other places
(the JAX kernel divides the f32 exponentials by their sum, casts, and divides
by 1 - p in bf16).
"""
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.ops.pallas_attention import fused_dropout_attention
from aspire_tpu_torch.ops.attention_kernel import (attention_keep_mask,
                                                   fused_attention_plain)
from test_torch_attention_bwd_tiles import keys_tile_probs

B, NH, HD = 2, 2, 64
WIDE = [128, 256]
DTYPES = {"float32": (jnp.float32, torch.float32, dict(atol=1e-5, rtol=0.0)),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, dict(atol=2e-2, rtol=2e-2))}


def key_tile(hd: int) -> int:
    """Keys a tile of the forward at head width hd (csrc/attention.cu,
    `BfCfg`): 64, but 32 at 256, where a stage of 64 keys would take 64 KB."""
    return 32 if hd == 256 else 64


def _case(t, seed, hd=HD):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, NH, t, hd)).astype(np.float32)
               for _ in range(3))
    keep = np.ones((B, t), bool)
    keep[0, t - t // 3:] = False        # padded keys
    keep[1, :] = False                  # a fully padded row: uniform probs
    bias = np.where(keep, 0.0, -1e9).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, (B, NH, t, t), dtype=np.uint32)
    return q, k, v, bias, bits


def decomposed_forward(q, k, v, bias, scale, p, keep):
    """ctx, the row stats m and l, and the scores and pd of each key tile, in
    the order of the CUDA kernel."""
    dtype, f = q.dtype, torch.float32
    b, nh, t, hd = q.shape
    tile = key_tile(hd)
    tp = -(-t // tile) * tile
    pad = torch.nn.functional.pad
    qf = q.to(f)
    kp, vp = (pad(x.to(f), (0, 0, 0, tp - t)) for x in (k, v))   # zero rows past t
    bias_p = pad(bias, (0, tp - t), value=-math.inf)

    def tile_scores(k0):
        return (qf @ kp[..., k0:k0 + tile, :].transpose(-1, -2) * scale
                + bias_p[:, None, None, k0:k0 + tile])

    # pass 1: each row's max and sum, online over the tiles
    m = torch.full((b, nh, t), -math.inf)
    l = torch.zeros((b, nh, t))
    for k0 in range(0, tp, tile):
        s = tile_scores(k0)
        m_new = torch.maximum(m, s.amax(-1))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(-1)
        m = m_new
    inv_l = 1.0 / l
    # pass 2: probabilities, mask, context
    inv_keep, keep_p = None, None
    if p > 0:
        inv_keep = 1.0 / float(torch.tensor(1.0 - p, dtype=dtype))
        keep_p = pad(keep, (0, tp - t), value=True)
    ctx = torch.zeros((b, nh, t, hd))
    tiles = []
    for k0 in range(0, tp, tile):
        s = tile_scores(k0)
        probs = torch.exp(s - m[..., None]) * inv_l[..., None]
        pd = probs if p == 0 else torch.where(
            keep_p[..., k0:k0 + tile], probs.to(dtype).to(f) * inv_keep, 0.0)
        pd = pd.to(dtype)
        ctx += pd.to(f) @ vp[..., k0:k0 + tile, :]
        tiles.append((s, pd))
    return ctx.to(dtype), m, l, tiles


def _inputs(t, p, td, hd=HD):
    q, k, v, bias, bits = _case(t, seed=t + int(p * 10), hd=hd)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    keep = attention_keep_mask(tq.shape, p, rng_bits=torch.from_numpy(
        bits.view(np.int32))) if p > 0 else None
    return (q, k, v, bias, bits), (tq, tk, tv, torch.from_numpy(bias)), keep


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("p", [0.1, 0.0])
@pytest.mark.parametrize("t", [64, 200, 512])
def test_decomposition_matches_pallas_and_plain(dtype, p, t):
    _check_decomposition(dtype, p, t, HD)


@pytest.mark.parametrize("hd", WIDE)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("p", [0.1, 0.0])
@pytest.mark.parametrize("t", [64, 200, 512])
def test_wide_decomposition_matches_pallas_and_plain(dtype, p, t, hd):
    _check_decomposition(dtype, p, t, hd)


def _check_decomposition(dtype, p, t, hd):
    jd, td, tol = DTYPES[dtype]
    (q, k, v, bias, bits), (tq, tk, tv, tb), keep = _inputs(t, p, td, hd)
    scale = 1.0 / math.sqrt(hd)
    ctx, m, l, _ = decomposed_forward(tq, tk, tv, tb, scale, p, keep)

    # the row stats the kernel leaves for the backward: the softmax's max and
    # sum over whole rows (another summation order)
    s = tq.float() @ tk.float().transpose(-1, -2) * scale + tb[:, None, None, :]
    torch.testing.assert_close(m, s.amax(-1), atol=1e-5, rtol=0.0)
    torch.testing.assert_close(l, torch.exp(s - m[..., None]).sum(-1), atol=0.0, rtol=1e-5)

    want_jax = fused_dropout_attention(
        *(jnp.asarray(a, jd) for a in (q, k, v)), jnp.asarray(bias),
        jnp.zeros((1,), jnp.uint32), dropout_p=p, sm_scale=float(scale),
        rng_bits=jnp.asarray(bits) if p > 0 else None, interpret=True)
    got = ctx.float().numpy()
    np.testing.assert_allclose(got, np.asarray(want_jax, np.float32), **tol,
                               err_msg="against the Pallas forward")
    want = fused_attention_plain(tq, tk, tv, tb, scale, p, keep)
    np.testing.assert_allclose(got, want.float().numpy(), **tol,
                               err_msg="against the plain version")
    if p == 0:                          # a fully padded row attends uniformly
        uniform = tv[1].float().mean(-2, keepdim=True).expand(got[1].shape)
        np.testing.assert_allclose(got[1], uniform.numpy(), **tol)


@pytest.mark.parametrize("p", [0.1, 0.0])
@pytest.mark.parametrize("t", [64, 200, 512])
def test_forward_pd_is_the_backward_pd(p, t):
    """The forward's pd and the one the backward's keys kernel recomputes
    from the same scores and the forward's m and l, bit for bit."""
    _check_pd(p, t, HD)


@pytest.mark.parametrize("hd", WIDE)
@pytest.mark.parametrize("p", [0.1, 0.0])
@pytest.mark.parametrize("t", [64, 200, 512])
def test_wide_forward_pd_is_the_backward_pd(p, t, hd):
    """The same at the wide widths, the forward's tiles of `key_tile` keys."""
    _check_pd(p, t, hd)


def _check_pd(p, t, hd):
    td = torch.bfloat16
    _, (tq, tk, tv, tb), keep = _inputs(t, p, td, hd)
    scale = 1.0 / math.sqrt(hd)
    _, m, l, tiles = decomposed_forward(tq, tk, tv, tb, scale, p, keep)
    inv_keep = 1.0 / float(torch.tensor(1.0 - p, dtype=td)) if p > 0 else None
    tile = key_tile(hd)
    for i, (s, pd) in enumerate(tiles):
        k0 = i * tile
        cols = min(tile, t - k0)
        keep_t = None if p == 0 else keep[..., k0:k0 + cols].transpose(-1, -2)
        _, pd_bwd = keys_tile_probs(s[..., :cols].transpose(-1, -2), m, 1.0 / l,
                                    keep_t, inv_keep, td)
        got = pd[..., :cols].view(torch.int16)
        want = pd_bwd.to(td).transpose(-1, -2).view(torch.int16)
        assert torch.equal(got, want), f"tile {i}: forward pd != backward pd"
