"""Port parity: ops/distances.py against the JAX package, train form and
`return_pair_sims` form, on the same numpy inputs (lens include 1)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.core.types import MultiVec as JMV
from aspire_tpu.ops import distances as jd
from aspire_tpu_torch.core.types import MultiVec as TMV
from aspire_tpu_torch.ops import distances as td

# f32 elementwise math and 16-term contractions: summation order only
TOL = dict(rtol=1e-5, atol=1e-5)
# OT scores pass through ~70 annealing rounds and exp((f + g - C) / blur)
# with blur 0.05, which multiplies potential differences by 20
OT_TOL = dict(rtol=2e-3, atol=2e-3)

B, SQ, SC, D = 5, 6, 7, 16


def _pair(rng):
    qe = rng.normal(size=(B, SQ, D)).astype(np.float32)
    ce = rng.normal(size=(B, SC, D)).astype(np.float32)
    ql = np.array([6, 3, 1, 4, 1], np.int32)
    cl = np.array([7, 1, 5, 2, 1], np.int32)
    qe *= (np.arange(SQ)[None, :] < ql[:, None])[:, :, None]
    ce *= (np.arange(SC)[None, :] < cl[:, None])[:, :, None]
    align = np.stack([rng.integers(0, SQ, B), rng.integers(0, SC, B)], 1).astype(np.int32)
    jq, jc = JMV(jnp.asarray(qe), jnp.asarray(ql)), \
        JMV(jnp.asarray(ce), jnp.asarray(cl), jnp.asarray(align))
    tq, tc = TMV(torch.from_numpy(qe), torch.from_numpy(ql)), \
        TMV(torch.from_numpy(ce), torch.from_numpy(cl), torch.from_numpy(align))
    return jq, jc, tq, tc


def _cmp(got, want, tol):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _cmp(g, w, tol)
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("name,kw", [
    ("l2max_dist", {}), ("l2topk_dist", {}), ("l2topk_dist", {"k": 3}),
    ("attention_dist", {}), ("attention_dist", {"temp": 5000.0}),
    ("jointsm_dist", {}),
])
@pytest.mark.parametrize("pair_sims", [False, True])
def test_distance_matches_jax(rng, name, kw, pair_sims):
    jq, jc, tq, tc = _pair(rng)
    got = getattr(td, name)(tq, tc, return_pair_sims=pair_sims, **kw)
    want = getattr(jd, name)(jq, jc, return_pair_sims=pair_sims, **kw)
    _cmp(got, want, TOL)


@pytest.mark.parametrize("name", ["l2sup_dist", "l2sup_weighted_dist"])
def test_supervised_distances_match_jax(rng, name):
    jq, jc, tq, tc = _pair(rng)
    _cmp(getattr(td, name)(tq, tc), getattr(jd, name)(jq, jc), TOL)


@pytest.mark.parametrize("kw", [
    dict(temp=5000.0), dict(temp=1.0), dict(temp=5000.0, diameter="pair"),
    dict(temp=5000.0, reach=1.5),
], ids=["temp5000", "temp1", "pair", "reach"])
@pytest.mark.parametrize("pair_sims", [False, True])
def test_wasserstein_matches_jax(rng, kw, pair_sims):
    jq, jc, tq, tc = _pair(rng)
    got = td.wasserstein_dist(tq, tc, return_pair_sims=pair_sims, **kw)
    want = jd.wasserstein_dist(jq, jc, return_pair_sims=pair_sims, **kw)
    _cmp(got, want, OT_TOL)


@pytest.mark.parametrize("diameter", ["global", "pair"])
def test_wasserstein_kernel_solver_matches_jax_pallas(rng, diameter):
    """solver='kernel' on CPU tensors runs the kernel's plain version; the JAX
    side runs its Pallas kernel in interpret mode."""
    jq, jc, tq, tc = _pair(rng)
    kw = dict(temp=5000.0, return_pair_sims=True, diameter=diameter)
    got = td.wasserstein_dist(tq, tc, solver="kernel", **kw)
    want = jd.wasserstein_dist(jq, jc, solver="pallas", **kw)
    _cmp(got, want, OT_TOL)
    ref = td.wasserstein_dist(tq, tc, solver="torch", **kw)
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), **OT_TOL)


def test_wasserstein_solver_arguments(rng):
    _, _, tq, tc = _pair(rng)
    with pytest.raises(ValueError, match="balanced"):
        td.wasserstein_dist(tq, tc, solver="kernel", reach=1.0)
    with pytest.raises(ValueError, match="solver"):
        td.wasserstein_dist(tq, tc, solver="pallas")


def test_wasserstein_train_gradient_matches_jax(rng):
    jq, jc, tq, tc = _pair(rng)
    emb = tq.embed.clone().requires_grad_(True)
    loss = td.wasserstein_dist(TMV(emb, tq.lens), tc, temp=5000.0).sum()
    loss.backward()
    jgrad = jax.grad(lambda e: jnp.sum(jd.wasserstein_dist(
        JMV(e, jq.lens), jc, temp=5000.0)))(jq.embed)
    assert bool(torch.isfinite(emb.grad).all())
    # gradients flow only through the last extrapolation step; f32 on both
    np.testing.assert_allclose(emb.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-3, atol=1e-4)


def test_single_sentence_ot_is_minus_l2(rng):
    x = rng.normal(size=(3, 1, D)).astype(np.float32)
    y = rng.normal(size=(3, 1, D)).astype(np.float32)
    one = torch.ones(3, dtype=torch.int32)
    sims, _ = td.wasserstein_dist(TMV(torch.from_numpy(x), one),
                                  TMV(torch.from_numpy(y), one),
                                  temp=5000.0, return_pair_sims=True)
    np.testing.assert_allclose(-sims.numpy(),
                               np.linalg.norm(x[:, 0] - y[:, 0], axis=1),
                               rtol=1e-4)


@pytest.mark.parametrize("agg", ["l2max", "l2lse", "l2top2", "l2wasserstein",
                                 "l2attention", "jointsm"])
def test_get_dist_function_registry(rng, agg):
    jq, jc, tq, tc = _pair(rng)

    class HP:
        geoml_blur, geoml_scaling, geoml_reach = 0.05, 0.9, None
        sent_sm_temp, cdatt_sm_temp = 5000.0, 2.0

    got = td.get_dist_function(agg, HP)(tq, tc)
    want = jd.get_dist_function(agg, HP)(jq, jc)
    _cmp(got, want, OT_TOL if agg == "l2wasserstein" else TOL)


def test_get_dist_function_unknown():
    with pytest.raises(ValueError, match="Unknown"):
        td.get_dist_function("nope")


def test_diameter_groups_equal_separate_calls(rng):
    """One OT call over a batch that holds several micro batches, each
    annealed from its own diameter, gives what separate calls give."""
    from aspire_tpu_torch.ops.sinkhorn import grouped_max_diameter, max_diameter
    parts = []
    for scale in (1.0, 3.0, 0.3):                    # clouds of different size
        _, _, tq, tc = _pair(rng)
        parts.append((TMV(tq.embed * scale, tq.lens), TMV(tc.embed * scale, tc.lens)))
    wide_q = TMV(torch.cat([q.embed for q, _ in parts]), torch.cat([q.lens for q, _ in parts]))
    wide_c = TMV(torch.cat([c.embed for _, c in parts]), torch.cat([c.lens for _, c in parts]))
    diam = grouped_max_diameter(wide_q.embed, wide_c.embed, 3)
    assert diam.shape == (3 * B,)
    for g, (q, c) in enumerate(parts):
        assert torch.equal(diam[g * B:(g + 1) * B],
                           max_diameter(q.embed, c.embed).expand(B))
    kw = dict(temp=5000.0)
    separate = torch.cat([td.wasserstein_dist(q, c, **kw) for q, c in parts])
    together = td.wasserstein_dist(wide_q, wide_c, diameter_value=diam, **kw)
    np.testing.assert_allclose(together.numpy(), separate.numpy(), rtol=1e-6)
    whole = td.wasserstein_dist(wide_q, wide_c, **kw)       # one diameter for all
    assert not np.allclose(whole.numpy(), separate.numpy(), rtol=1e-6)
    fn = td.get_dist_function("l2wasserstein")
    np.testing.assert_allclose(fn(wide_q, wide_c, diameter_value=diam).numpy(),
                               td.wasserstein_dist(wide_q, wide_c, diameter_value=diam).numpy())
    with pytest.raises(ValueError, match="groups"):
        grouped_max_diameter(wide_q.embed, wide_c.embed, 4)
