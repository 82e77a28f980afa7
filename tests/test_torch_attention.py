"""Port parity: the plain version of the CUDA attention kernel (what the
wrapper runs on CPU tensors) against the JAX package's Pallas kernel in
interpret mode at dropout_p=0 and against its pure-jnp reference."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.ops.pallas_attention import (dropout_attention_reference,
                                             fused_dropout_attention)
from aspire_tpu_torch.ops.attention_kernel import (fused_attention,
                                                   fused_attention_plain)

B, NH, T, HD = 3, 4, 24, 16
SCALE = 1.0 / np.sqrt(HD)


def _inputs(rng):
    q, k, v = (rng.normal(size=(B, NH, T, HD)).astype(np.float32)
               for _ in range(3))
    keep = np.ones((B, T), bool)
    keep[1, 17:] = False            # padded keys
    keep[2, :] = False              # a fully padded row (batch padding)
    bias = np.where(keep, 0.0, -1e9).astype(np.float32)
    return q, k, v, bias


def _jax_both(q, k, v, bias, dtype):
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    kernel = fused_dropout_attention(jq, jk, jv, jnp.asarray(bias),
                                     jnp.zeros((1,), jnp.uint32), dropout_p=0.0,
                                     sm_scale=float(SCALE), interpret=True)
    ref = dropout_attention_reference(jq, jk, jv, jnp.asarray(bias),
                                      jnp.ones((B, NH, T, T), bool), 0.0,
                                      float(SCALE))
    return (np.asarray(kernel, np.float32), np.asarray(ref, np.float32))


@pytest.mark.parametrize("dtype,atol", [
    # f32: summation order and the exp routine only
    ("float32", 1e-5),
    # bf16: the probabilities and the context are each rounded to bf16 (8
    # bits, ulp 2^-7 at O(1) values); a flipped ulp or two gives ~2e-2
    ("bfloat16", 2e-2),
])
def test_plain_attention_matches_pallas_and_reference(rng, dtype, atol):
    q, k, v, bias = _inputs(rng)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = fused_attention(tq, tk, tv, torch.from_numpy(bias), float(SCALE))
    assert got.dtype == tdt and got.shape == (B, NH, T, HD)
    got = got.float().numpy()
    kernel, ref = _jax_both(q, k, v, bias, getattr(jnp, dtype))
    np.testing.assert_allclose(got, kernel, atol=atol)
    np.testing.assert_allclose(got, ref, atol=atol)


def test_fully_padded_row_gives_uniform_average(rng):
    q, k, v, bias = _inputs(rng)
    got = fused_attention_plain(*(torch.from_numpy(a) for a in (q, k, v, bias)),
                                float(SCALE)).numpy()
    assert np.isfinite(got).all()
    want = np.broadcast_to(v[2].mean(axis=1, keepdims=True), v[2].shape)
    np.testing.assert_allclose(got[2], want, atol=1e-5)


def test_strided_views_are_taken_as_they_are(rng):
    """The model hands [b, t, nh, hd] projections viewed as [b, nh, t, hd]."""
    q, k, v, bias = _inputs(rng)
    views = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
             .permute(0, 2, 1, 3) for a in (q, k, v)]
    assert not views[0].is_contiguous()
    got = fused_attention(*views, torch.from_numpy(bias), float(SCALE))
    want = fused_attention_plain(*(torch.from_numpy(a) for a in (q, k, v, bias)),
                                 float(SCALE))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_cpu_tensors_count_no_launch(rng):
    q, k, v, bias = _inputs(rng)
    before = fused_attention.launches
    fused_attention(*(torch.from_numpy(a) for a in (q, k, v, bias)), float(SCALE))
    assert fused_attention.launches == before


def test_dropout_and_bad_shapes_raise(rng):
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(rng))
    with pytest.raises(NotImplementedError, match="training slice"):
        fused_attention(q, k, v, bias, float(SCALE), dropout_p=0.1)
    with pytest.raises(ValueError, match="bias"):
        fused_attention(q, k, v, bias[:, :-1], float(SCALE))
    with pytest.raises(ValueError, match="share"):
        fused_attention(q, k[:, :, :-1], v, bias, float(SCALE))
