"""Port parity: core/types.py and ops/cdist.py against the JAX package.

Both sides get the same numpy inputs from a seed.  Everything is float32
elementwise math and one short contraction, so atol 1e-5 covers summation
order and the two softmax/exp routines.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.core import types as jt
from aspire_tpu.ops.cdist import pairwise_l2 as j_pairwise_l2
from aspire_tpu_torch.core import types as tt
from aspire_tpu_torch.ops.cdist import pairwise_l2

ATOL = 1e-5


def _mv(rng, b, s, d, lens):
    embed = rng.normal(size=(b, s, d)).astype(np.float32)
    return embed, np.asarray(lens, np.int32)


def test_constants_match():
    assert tt.PAD_NEG == jt.PAD_NEG == -10e8
    assert tt.SOFTMAX_NEG == jt.SOFTMAX_NEG == -1e32


def test_multivec_masks(rng):
    e1, l1 = _mv(rng, 3, 5, 8, [5, 2, 1])
    e2, l2 = _mv(rng, 3, 7, 8, [3, 7, 1])
    jq, jc = jt.MultiVec(jnp.asarray(e1), jnp.asarray(l1)), \
        jt.MultiVec(jnp.asarray(e2), jnp.asarray(l2))
    tq, tc = tt.MultiVec(torch.from_numpy(e1), torch.from_numpy(l1)), \
        tt.MultiVec(torch.from_numpy(e2), torch.from_numpy(l2))
    assert (tq.batch, tq.max_sents, tq.dim) == (3, 5, 8)
    np.testing.assert_array_equal(tq.sent_mask().numpy(),
                                  np.asarray(jq.sent_mask()))
    np.testing.assert_array_equal(tq.pair_pad_mask(tc).numpy(),
                                  np.asarray(jq.pair_pad_mask(jc)))
    moved = tq.to("cpu")
    assert moved.align is None and moved.embed.device.type == "cpu"


def test_masked_softmaxes(rng):
    s1 = rng.normal(size=(4, 9)).astype(np.float32)
    lens = np.array([9, 4, 1, 6], np.int32)
    np.testing.assert_allclose(
        tt.masked_softmax(torch.from_numpy(s1), torch.from_numpy(lens)).numpy(),
        np.asarray(jt.masked_softmax(jnp.asarray(s1), jnp.asarray(lens))),
        atol=ATOL)
    s2 = rng.normal(size=(4, 6, 5)).astype(np.float32)
    l1 = np.array([6, 1, 3, 2], np.int32)
    l2 = np.array([5, 1, 2, 5], np.int32)
    got = tt.masked_2d_softmax(torch.from_numpy(s2), torch.from_numpy(l1),
                               torch.from_numpy(l2)).numpy()
    want = np.asarray(jt.masked_2d_softmax(jnp.asarray(s2), jnp.asarray(l1),
                                           jnp.asarray(l2)))
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got.sum(axis=(1, 2)), 1.0, atol=ATOL)


@pytest.mark.parametrize("squared", [False, True])
def test_pairwise_l2_matches(rng, squared):
    q = rng.normal(size=(3, 6, 32)).astype(np.float32)
    c = rng.normal(size=(3, 4, 32)).astype(np.float32)
    got = pairwise_l2(torch.from_numpy(q), torch.from_numpy(c), squared).numpy()
    want = np.asarray(j_pairwise_l2(jnp.asarray(q), jnp.asarray(c), squared))
    # squared distances are O(64): allow the same relative slack
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


def test_pairwise_l2_coincident_points_zero_and_finite_grad(rng):
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    y = rng.normal(size=(2, 4, 16)).astype(np.float32)
    x[:, 3:] = 0.0                                  # zero pads coincide
    y[:, 2:] = 0.0
    q = torch.from_numpy(x).requires_grad_(True)
    d = pairwise_l2(q, torch.from_numpy(y))
    assert float(d[0, 3, 2].detach()) == 0.0 and float(d[1, 4, 3].detach()) == 0.0
    d.sum().backward()
    assert bool(torch.isfinite(q.grad).all())
    jgrad = jax.grad(lambda a: jnp.sum(j_pairwise_l2(a, jnp.asarray(y))))(
        jnp.asarray(x))
    np.testing.assert_allclose(q.grad.numpy(), np.asarray(jgrad), atol=ATOL)


def test_pairwise_l2_keeps_nan_visible(rng):
    x = rng.normal(size=(1, 3, 8)).astype(np.float32)
    y = x.copy()
    y[0, 1, 2] = np.nan
    d = pairwise_l2(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    jd = np.asarray(j_pairwise_l2(jnp.asarray(x), jnp.asarray(y)))
    assert np.isnan(d[0, :, 1]).all() and np.isfinite(d[0, :, 0]).all()
    np.testing.assert_array_equal(np.isnan(d), np.isnan(jd))


def test_require_device_refuses_absent_cuda():
    if torch.cuda.is_available():
        assert tt.require_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tt.require_device("cuda")
    assert tt.require_device("cpu").type == "cpu"
