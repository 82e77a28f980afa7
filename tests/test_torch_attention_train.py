"""Port parity: ops/attention_kernel.py in training against the JAX package's
fused_dropout_attention (Pallas forward and backward kernels in interpret
mode): the same numpy q, k, v, bias, cotangent and explicit bits through both,
forward and gradients in q, k, v, at p = 0.1 and p = 0, with padded keys, a
fully padded row and a ragged length.

float32 atol 1e-5: another summation order and exp routine.  bfloat16 atol
2e-2: each output is rounded to bf16 once on each side, and ordinary autograd
of the plain version rounds the probabilities' cotangent to bf16 where the
Pallas backward keeps it in f32.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.ops.pallas_attention import fused_dropout_attention
from aspire_tpu_torch.ops.attention_kernel import (attention_keep_mask,
                                                   fused_attention,
                                                   fused_attention_plain)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
B, NH, HD = 3, 2, 8


def _case(rng, t):
    q, k, v, g = (rng.standard_normal((B, NH, t, HD)).astype(np.float32)
                  for _ in range(4))
    keep = np.ones((B, t), bool)
    keep[1, t // 2:] = False            # padded keys
    keep[2, :] = False                  # a fully padded row: uniform probs
    bias = np.where(keep, 0.0, -1e9).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, (B, NH, t, t), dtype=np.uint32)
    return q, k, v, g, bias, bits


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("p", [0.1, 0.0])
@pytest.mark.parametrize("t", [16, 13])
def test_forward_and_gradients_match_pallas(rng, dtype, p, t):
    jd, td, atol = DTYPES[dtype]
    q, k, v, g, bias, bits = _case(rng, t)
    scale = 1.0 / np.sqrt(HD)

    def jax_out(qj, kj, vj):
        return fused_dropout_attention(
            qj, kj, vj, jnp.asarray(bias), jnp.zeros((1,), jnp.uint32),
            dropout_p=p, sm_scale=float(scale),
            rng_bits=jnp.asarray(bits) if p > 0 else None, interpret=True)

    want, vjp = jax.vjp(jax_out, *(jnp.asarray(a, jd) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(g, jd))

    leaves = [torch.from_numpy(a).to(td).requires_grad_(True) for a in (q, k, v)]
    got = fused_attention(*leaves, torch.from_numpy(bias), float(scale), p,
                          rng_bits=torch.from_numpy(bits.view(np.int32))
                          if p > 0 else None)
    got.backward(torch.from_numpy(g).to(td))
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol)
    for leaf, wg, name in zip(leaves, want_grads, "qkv"):
        assert bool(torch.isfinite(leaf.grad).all())
        np.testing.assert_allclose(leaf.grad.float().numpy(),
                                   np.asarray(wg, np.float32), atol=atol,
                                   err_msg=f"d{name}")


def test_bias_gets_no_gradient_and_padded_row_is_finite(rng):
    q, k, v, g, bias, bits = _case(rng, 16)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tb = torch.from_numpy(bias)
    out = fused_attention(*leaves, tb, 0.35, 0.1, seed=5, site=2)
    out.backward(torch.from_numpy(g))
    assert not tb.requires_grad
    for leaf in leaves:
        assert bool(torch.isfinite(leaf.grad).all())


def test_philox_route_matches_plain_version_with_its_mask(rng):
    q, k, v, g, bias, _ = (torch.from_numpy(a) for a in _case(rng, 16))
    a = fused_attention(q, k, v, bias, 0.35, 0.1, seed=5, site=2)
    keep = attention_keep_mask(q.shape, 0.1, seed=5, site=2)
    assert keep.shape == (B, NH, 16, 16)
    assert torch.equal(a, fused_attention_plain(q, k, v, bias, 0.35, 0.1, keep))
    assert torch.equal(a, fused_attention(q, k, v, bias, 0.35, 0.1, seed=5, site=2))
    assert not torch.equal(a, fused_attention(q, k, v, bias, 0.35, 0.1, seed=6, site=2))
    assert not torch.equal(a, fused_attention(q, k, v, bias, 0.35, 0.1, seed=5, site=3))
    # p = 0 ignores seed and bits alike
    assert torch.equal(fused_attention(q, k, v, bias, 0.35),
                       fused_attention(q, k, v, bias, 0.35, 0.0, seed=5))


def test_dropped_probabilities_are_scaled_in_the_compute_dtype(rng):
    """bf16: the cast probability is divided by bf16(1 - p), not by 1 - p."""
    q, k, v, _, bias, _ = (torch.from_numpy(a) for a in _case(rng, 16))
    q, k = q.bfloat16(), k.bfloat16()
    eye = torch.zeros((B, NH, 16, HD), dtype=torch.bfloat16)
    eye[:, :, torch.arange(HD), torch.arange(HD)] = 1.0     # picks keys 0..7
    zero_bias = torch.zeros_like(bias)
    keep_all = torch.ones((B, NH, 16, 16), dtype=torch.bool)
    probs = fused_attention_plain(q, k, eye, zero_bias, 0.35)
    dropped = fused_attention_plain(q, k, eye, zero_bias, 0.35, 0.1, keep_all)
    div = torch.tensor(0.9, dtype=torch.bfloat16)
    assert float(div) != 0.9
    assert torch.equal(dropped, probs / div)


def test_cpu_tensors_count_no_training_launch(rng):
    q, k, v, g, bias, _ = (torch.from_numpy(a) for a in _case(rng, 16))
    before = (fused_attention.launches, fused_attention.dropout_launches,
              fused_attention.bwd_launches)
    q.requires_grad_(True)
    fused_attention(q, k, v, bias, 0.35, 0.1, seed=1).backward(g)
    assert before == (fused_attention.launches, fused_attention.dropout_launches,
                      fused_attention.bwd_launches)
