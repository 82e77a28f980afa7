"""Port parity: models/layers.py against the Flax layers on bridged weights
and the same numpy inputs (float32, atol 1e-5: small dense products in
another summation order)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.models import layers as jl
from aspire_tpu_torch.models import layers as tl
from aspire_tpu_torch.models.convert import (flax_params_from_state_dict,
                                             state_dict_from_flax_params)

ATOL = 1e-5


def _params(module, rng, *args):
    params = module.init(jax.random.key(0), *args)["params"]
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.3 * rng.standard_normal(x.shape).astype(np.float32),
        params)


def test_straight_through_forward_and_clamped_gradient(rng):
    x = rng.standard_normal((4, 6)).astype(np.float32)
    x[0, 0] = 0.0                                     # the step is 1 at 0
    g = (rng.standard_normal((4, 6)) * 3).astype(np.float32)
    want, vjp = jax.vjp(jl.straight_through, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tl.straight_through(xt)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_dx))
    assert float(xt.grad.abs().max()) <= 1.0 and float(np.abs(g).max()) > 1.0


@pytest.mark.parametrize("kw", [
    dict(out_dim=5),
    dict(out_dim=5, non_linearity="tanh", composition_dims=(7, 6)),
    dict(out_dim=1, non_linearity="softplus", composition_dims=(7,),
         score_ffn=True, use_bias=False),
    dict(out_dim=4, non_linearity="sigmoid", composition_dims=(3,)),
], ids=["single", "tanh-3-layer", "score-head", "sigmoid"])
def test_feed_forward_net_matches_flax(rng, kw):
    x = rng.standard_normal((3, 9)).astype(np.float32)
    jmod = jl.FeedForwardNet(**kw)
    params = _params(jmod, rng, x)
    want = jmod.apply({"params": params}, x)
    tmod = tl.FeedForwardNet(9, device="cpu", **kw).eval()
    state = state_dict_from_flax_params(params)
    assert set(state) == set(tmod.state_dict())
    tmod.load_state_dict(state)
    got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    # and the way back gives the Flax tree again
    back = flax_params_from_state_dict(tmod.state_dict())
    for name in params:
        for leaf in params[name]:
            np.testing.assert_array_equal(back[name][leaf], params[name][leaf])


def test_feed_forward_net_dropout_only_in_train_mode(rng):
    x = torch.from_numpy(rng.standard_normal((64, 9)).astype(np.float32))
    mod = tl.FeedForwardNet(9, 4, composition_dims=(32,), dropout_p=0.5,
                            device="cpu")
    mod.eval()
    assert torch.equal(mod(x), mod(x))
    mod.train()
    torch.manual_seed(0)
    a = mod(x)
    torch.manual_seed(1)
    assert not torch.equal(a, mod(x))


def test_gated_attention_matches_flax_and_masks_pads(rng):
    x = rng.standard_normal((3, 6, 8)).astype(np.float32)
    lens = np.array([6, 2, 4], np.int32)
    jmod = jl.GatedAttention(embed_dim=5)
    params = _params(jmod, rng, x, lens)
    want = jmod.apply({"params": params}, x, lens)
    tmod = tl.GatedAttention(8, 5, device="cpu")
    tmod.load_state_dict(state_dict_from_flax_params(params))
    got = tmod(torch.from_numpy(x), torch.from_numpy(lens)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)
    assert got[1, 2:].max() == 0.0
