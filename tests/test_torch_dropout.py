"""Port parity: ops/dropout_kernel.py against the JAX package's hw_dropout
(Pallas kernel in interpret mode) on the same numpy inputs and the same
explicit bits -- exact, forward and gradient, in float32 and bfloat16 -- and
the port's own Philox route (deterministic per seed, distinct per site)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.ops.pallas_dropout import hw_dropout
from aspire_tpu_torch.ops import philox
from aspire_tpu_torch.ops.dropout_kernel import (dropout_plain, fused_dropout,
                                                 keep_mask)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _case(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
    return x, g, bits


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape,p", [((16, 32), 0.1), ((3, 5, 16), 0.5)])
def test_forward_and_gradient_match_hw_dropout_exactly(rng, dtype, shape, p):
    jd, td = DTYPES[dtype]
    x, g, bits = _case(rng, shape)
    seed = jnp.zeros((1,), jnp.uint32)

    def jax_out(xj):
        return hw_dropout(xj, seed, dropout_p=p, rng_bits=jnp.asarray(bits),
                          interpret=True)

    xj = jnp.asarray(x, jd)
    want, vjp = jax.vjp(jax_out, xj)
    (want_dx,) = vjp(jnp.asarray(g, jd))

    xt = torch.from_numpy(x).to(td).requires_grad_(True)
    tbits = torch.from_numpy(bits.view(np.int32))
    got = fused_dropout(xt, p, rng_bits=tbits)
    got.backward(torch.from_numpy(g).to(td))
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want, np.float32))
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(want_dx, np.float32))


def test_p_zero_is_identity_without_launch(rng):
    x = torch.from_numpy(_case(rng, (4, 8))[0])
    before = fused_dropout.launches
    assert fused_dropout(x, 0.0) is x
    assert fused_dropout.launches == before


def test_philox_route_is_deterministic_per_seed_and_site(rng):
    x = torch.from_numpy(_case(rng, (64, 48))[0])
    a = fused_dropout(x, 0.1, seed=9, site=3)
    assert torch.equal(a, fused_dropout(x, 0.1, seed=9, site=3))
    assert not torch.equal(a, fused_dropout(x, 0.1, seed=10, site=3))
    assert not torch.equal(a, fused_dropout(x, 0.1, seed=9, site=4))
    keep = keep_mask(x.shape, 0.1, seed=9, site=3)
    assert torch.equal(a, dropout_plain(x, keep, 0.1))
    assert torch.equal(keep, philox.hidden_bits(9, 3, 64, 48)
                       >= philox.keep_threshold(0.1))
    # the same bits whatever leading shape the rows come in
    b = fused_dropout(x.reshape(4, 16, 48), 0.1, seed=9, site=3)
    assert torch.equal(a, b.reshape(64, 48))


def test_keep_rate_scale_and_gradient_mask(rng):
    p = 0.25
    x = torch.ones((256, 256), requires_grad=True)
    out = fused_dropout(x, p, seed=1)
    out.sum().backward()
    kept = out.detach() != 0
    assert abs(float(kept.float().mean()) - (1 - p)) < 0.01
    scale = torch.tensor(1.0 / (1.0 - p))
    assert torch.equal(out.detach()[kept], scale.expand(int(kept.sum())))
    assert torch.equal(x.grad, out.detach())      # same mask, same scale


def test_argument_checks(rng):
    x = torch.from_numpy(_case(rng, (4, 8))[0])
    with pytest.raises(ValueError, match="seed or rng_bits"):
        fused_dropout(x, 0.1)
    with pytest.raises(ValueError, match="dropout_p"):
        fused_dropout(x, 1.0, seed=1)
    with pytest.raises(ValueError, match="shape"):
        fused_dropout(x, 0.1, rng_bits=torch.zeros((4, 4), dtype=torch.int32))
