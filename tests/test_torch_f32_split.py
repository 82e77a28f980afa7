"""The split-TF32 (3xTF32) arithmetic of the f32 kernels (csrc/common.cuh
tf32_split, csrc/ffn.cu ffn_tf32x3_kernel, csrc/attention.cu
attention_tf32x3_kernel), written out in plain PyTorch on the CPU.

An f32 operand x is split as hi = tf32(x) (cvt.rna.tf32.f32: 10 stored
mantissa bits, nearest, ties away from zero) and lo = tf32(x - hi), and a
product a.b is summed as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi.  Here the rounding
is emulated on the int32 view of the floats (add 0x1000, clear the low 13
bits), and a product of two TF32 values, 11 x 11 significant bits, is exact in
f32, so an f32 matmul of the parts computes each TF32 product as the tensor
cores do; the sums differ from the card's in their order and rounding (the
tensor cores add with truncation, which the kernels confine to short sums).

Inputs are finite and below 2^127 in magnitude: from there up the rounding can
carry into the exponent and give inf (as cvt.rna does for the largest
floats), and hi + lo is then not x.  The kernels' inputs (activations,
weights, scores) are far from that range.

The FFN and the one-walk attention forward built on these products are held
against the JAX package's Pallas kernels in interpret mode and the port's plain
versions, on the same numpy inputs; the one-walk forward also at heads wider
than 64 (csrc/attention.cu attention_tf32x3_walk_kernel at one walk), on the
key tiles its kernel takes there.
"""
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from aspire_tpu.ops.pallas_attention import fused_dropout_attention
from aspire_tpu.ops.pallas_ffn import fused_ffn as j_fused_ffn
from aspire_tpu_torch.ops.attention_kernel import fused_attention_plain
from aspire_tpu_torch.ops.ffn_kernel import fused_ffn_plain
from test_torch_attention_fwd_tiles import _case

LOW13 = 0x1FFF
TILE = 64


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on f32 x (finite, below 2^127), by integer ops."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~LOW13).view(torch.float32)


def tf32_split(x: torch.Tensor):
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels sum it: the cross terms, then hi.hi; lo.lo dropped."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return al @ bh + ah @ bl + ah @ bh


def _numpy_rna(x: np.ndarray) -> np.ndarray:
    """The same rounding, modelled independently: |x| rounded to a multiple
    of 2^(e - 10), e the exponent of |x| (subnormals: of the smallest
    normal), halves away from zero."""
    x64 = x.astype(np.float64)
    _, e = np.frexp(np.abs(x64))                 # |x| = m 2^e, m in [0.5, 1)
    e = np.maximum(e - 1, -126)
    ulp = np.ldexp(1.0, e - 10)
    mag = np.floor(np.abs(x64) / ulp + 0.5) * ulp
    return np.copysign(mag, x64).astype(np.float32)


def _spread(n: int, seed: int) -> np.ndarray:
    """Floats of both signs over the normal exponents below 2^127, every
    subnormal binade, zeros and ties of the rounding."""
    rng = np.random.default_rng(seed)
    normal = rng.uniform(1.0, 2.0, n) * np.exp2(rng.integers(-126, 127, n))
    sub = rng.integers(1, 2 ** 23, n).astype(np.uint32).view(np.float32)
    tie = (rng.integers(0x00800000, 0x7F000000, n, dtype=np.uint32) & ~np.uint32(LOW13)
           | np.uint32(0x1000)).view(np.float32)
    vals = np.concatenate([normal.astype(np.float32), sub, tie,
                           np.float32([0.0, -0.0, 1.0, 1.0 + 2.0 ** -11])])
    signs = rng.choice(np.float32([-1.0, 1.0]), vals.size)
    return (vals * signs).astype(np.float32)


def test_rounding_matches_an_independent_model():
    x = _spread(20000, seed=1)
    got = tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), _numpy_rna(x).view(np.uint32))
    # ties go away from zero: 1 + 2^-11 is halfway between two TF32 values
    assert got[-1] * np.sign(x[-1]) == np.float32(1.0 + 2.0 ** -10)
    assert np.all((got.view(np.uint32) & LOW13) == 0)


def test_split_is_exact_and_tf32():
    x = torch.from_numpy(_spread(20000, seed=2))
    hi = tf32_round(x)
    rest = x - hi                                # exact in f32
    # bit for bit, but -0.0, for which hi + rest is +0.0
    nonzero = x != 0
    assert torch.equal((hi + rest)[nonzero].view(torch.int32),
                       x[nonzero].view(torch.int32)), "hi + (x - hi) != x"
    assert bool((hi + rest)[~nonzero].eq(0).all())
    _, lo = tf32_split(x)
    assert not bool(((hi.view(torch.int32) & LOW13) != 0).any())
    assert not bool(((lo.view(torch.int32) & LOW13) != 0).any())
    # |x - hi - lo| <= 2^-22 |x| (lo's own rounding) where lo, a multiple of
    # x's ulp, is a normal float: |x| >= 2^-100
    normal = x.abs() >= 2.0 ** -100
    resid = (x.double() - hi.double() - lo.double()).abs()
    assert bool((resid[normal] <= 2.0 ** -22 * x.double().abs()[normal]).all())


def _ffn_inputs(rows=64, h=768, f=3072, seed=5):
    rng = np.random.default_rng(seed)
    mk = lambda *s, scale: (rng.standard_normal(s) * scale).astype(np.float32)
    return (mk(rows, h, scale=1.0), mk(h, f, scale=0.02), mk(f, scale=0.02),
            mk(f, h, scale=0.02), mk(h, scale=0.02))


def ffn_3xtf32(x, w1, b1, w2, b2):
    """The f32 kernel's two launches: the activation is split where launch
    1's epilogue stores its parts, and launch 2 reads those."""
    h = F.gelu(matmul_3xtf32(x, w1) + b1, approximate="none")
    return matmul_3xtf32(h, w2) + b2


@pytest.mark.parametrize("against", ["pallas", "plain", "f64"])
def test_ffn_3xtf32(against):
    """768 -> 3072 -> 768 on 64 rows, atol 1e-4 (the kernel's tolerance on
    the card): another summation order and, against Pallas, its polynomial
    erf (1.5e-7).  Against an f64 FFN the split products stay within 4x of
    the error of the plain f32 products."""
    arrs = _ffn_inputs()
    t = [torch.from_numpy(a) for a in arrs]
    got = ffn_3xtf32(*t)
    if against == "pallas":
        want = np.asarray(j_fused_ffn(*(jnp.asarray(a) for a in arrs),
                                      interpret=True), np.float32)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    elif against == "plain":
        want = fused_ffn_plain(*t)
        err = float((got - want).abs().max())
        assert err <= 1e-4, f"max error {err} against the plain FFN"
    else:
        x, w1, b1, w2, b2 = (a.double() for a in t)
        ref = F.gelu(x @ w1 + b1, approximate="none") @ w2 + b2
        err = float((got.double() - ref).abs().max())
        plain_err = float((fused_ffn_plain(*t).double() - ref).abs().max())
        assert err <= 4 * plain_err, (err, plain_err)


def attention_one_walk(q, k, v, bias, scale, tile=TILE):
    """The f32 attention kernel without dropout: key tiles of `tile` walked
    once, online max and sum, the context rescaled and divided by the sum at
    the end; both products 3xTF32."""
    b, nh, t, hd = q.shape
    tp = -(-t // tile) * tile
    kp, vp = (F.pad(x, (0, 0, 0, tp - t)) for x in (k, v))   # zero rows past t
    bias_p = F.pad(bias, (0, tp - t), value=-math.inf)
    m = torch.full((b, nh, t), -math.inf)
    l = torch.zeros((b, nh, t))
    ctx = torch.zeros((b, nh, t, hd))
    for k0 in range(0, tp, tile):
        s = (matmul_3xtf32(q, kp[..., k0:k0 + tile, :].transpose(-1, -2)) * scale
             + bias_p[:, None, None, k0:k0 + tile])
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        e = torch.exp(s - m_new[..., None])
        l = l * corr + e.sum(-1)
        ctx = ctx * corr[..., None] + matmul_3xtf32(e, vp[..., k0:k0 + tile, :])
        m = m_new
    return ctx / l[..., None]


@pytest.mark.parametrize("t", [64, 200, 512])
def test_attention_one_walk_3xtf32(t):
    """Padded keys in one row, a fully padded row, at the f32 atol of
    test_torch_attention_fwd_tiles.py (1e-5): another summation order and
    exp routine, and the division by the sum taken after p.v."""
    q, k, v, bias, _ = _case(t, seed=t)
    tq, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
    scale = 1.0 / math.sqrt(q.shape[-1])
    got = attention_one_walk(tq, tk, tv, tb, scale).numpy()
    want_jax = fused_dropout_attention(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(bias),
        jnp.zeros((1,), jnp.uint32), dropout_p=0.0, sm_scale=float(scale),
        interpret=True)
    np.testing.assert_allclose(got, np.asarray(want_jax, np.float32), atol=1e-5,
                               rtol=0, err_msg="against the Pallas forward")
    want = fused_attention_plain(tq, tk, tv, tb, scale).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                               err_msg="against the plain version")
    uniform = tv[1].mean(-2, keepdim=True).expand(got[1].shape)
    np.testing.assert_allclose(got[1], uniform.numpy(), atol=1e-5, rtol=0)


# padded head width -> keys a tile of the one-walk forward
WIDE_TILES = {128: 32, 192: 16, 256: 16}


@pytest.mark.parametrize("hd", [96, 128, 192, 256])
def test_attention_one_walk_3xtf32_wide(hd):
    """At t = 200 (several key tiles, the last one partial), padded keys in
    one row and a fully padded row, the head zero-padded to its kernel's
    width: the first hd columns against the Pallas forward at width hd and
    the plain version (atol 1e-5, as at 64)."""
    t, width = 200, -(-hd // 64) * 64
    q, k, v, bias, _ = _case(t, seed=t + hd, hd=hd)
    tq, tk, tv = (F.pad(torch.from_numpy(a), (0, width - hd)) for a in (q, k, v))
    tb = torch.from_numpy(bias)
    scale = 1.0 / math.sqrt(hd)
    got = attention_one_walk(tq, tk, tv, tb, scale, WIDE_TILES[width]).numpy()
    want_jax = fused_dropout_attention(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(bias),
        jnp.zeros((1,), jnp.uint32), dropout_p=0.0, sm_scale=float(scale),
        interpret=True)
    np.testing.assert_allclose(got[..., :hd], np.asarray(want_jax, np.float32), atol=1e-5,
                               rtol=0, err_msg="against the Pallas forward")
    want = fused_attention_plain(tq, tk, tv, tb, scale).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                               err_msg="against the plain version")
    assert not got[..., hd:].any()
    uniform = tv[1].mean(-2, keepdim=True).expand(got[1].shape)
    np.testing.assert_allclose(got[1], uniform.numpy(), atol=1e-5, rtol=0)
