"""Port parity: ops/sinkhorn.py and the plain version of the CUDA Sinkhorn
kernel against the JAX package's two solvers (XLA and Pallas in interpret
mode), on the same numpy inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.ops import sinkhorn as js
from aspire_tpu.ops.pallas_sinkhorn import sinkhorn_potentials_pallas
from aspire_tpu_torch.ops import sinkhorn as ts
from aspire_tpu_torch.ops.sinkhorn_kernel import (
    large_bytes, pair_bytes, sinkhorn_potentials_kernel, sinkhorn_route,
    sinkhorn_solve, sinkhorn_solve_plain)

# The same f32 algorithm on both sides; ~70 annealing rounds compound the
# differences of the two logsumexp routines and summation orders.
TOL = dict(rtol=1e-4, atol=1e-4)
# The kernel form multiplies by 1/eps and builds eps from exp(k log s) where
# the solver divides and uses pow; the JAX package holds its own two solvers
# to 2e-3 (tests/test_pallas.py).
KTOL = dict(rtol=1e-3, atol=1e-3)


def _clouds(rng, bsz=5, n=7, m=11, d=16, scale=1.0):
    x = (rng.normal(size=(bsz, n, d)) * scale).astype(np.float32)
    y = (rng.normal(size=(bsz, m, d)) * scale).astype(np.float32)
    a = rng.random((bsz, n)).astype(np.float32) + 0.1
    b = rng.random((bsz, m)).astype(np.float32) + 0.1
    a[:, -2:] = 0.0
    b[:, -3:] = 0.0
    a /= a.sum(1, keepdims=True)
    b /= b.sum(1, keepdims=True)
    return a, x, b, y


def _t(*arrs):
    return [torch.from_numpy(np.asarray(v)) for v in arrs]


def _j(*arrs):
    return [jnp.asarray(v) for v in arrs]


def _check_mass(got, want, mass, tol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[mass > 0], want[mass > 0], **tol)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(reach=2.0),
    dict(diameter="pair"),
    dict(diameter_value=3.5),
    dict(blur=0.3, scaling=0.7, max_iters=8),
], ids=["balanced", "reach", "pair", "diameter_value", "capped"])
def test_sinkhorn_potentials_matches_jax(rng, kw):
    a, x, b, y = _clouds(rng)
    f, g = ts.sinkhorn_potentials(*_t(a, x, b, y), **kw)
    jkw = dict(kw)
    if "diameter_value" in jkw:
        jkw["diameter_value"] = jnp.float32(jkw["diameter_value"])
    fj, gj = js.sinkhorn_potentials(*_j(a, x, b, y), **jkw)
    _check_mass(f, fj, a, TOL)
    _check_mass(g, gj, b, TOL)
    cost = ts.sinkhorn_cost(*_t(a), f, *_t(b), g, reach=kw.get("reach"),
                            blur=kw.get("blur", 0.05))
    cost_j = js.sinkhorn_cost(a, fj, b, gj, reach=kw.get("reach"),
                              blur=kw.get("blur", 0.05))
    np.testing.assert_allclose(cost.numpy(), np.asarray(cost_j), **TOL)


def test_sinkhorn_diameter_below_blur(rng):
    """d < blur runs geomloss's [d, blur] schedule, not [blur, blur]."""
    a, x, b, y = _clouds(rng, scale=1e-3)
    f, g = ts.sinkhorn_potentials(*_t(a, x, b, y))
    fj, gj = js.sinkhorn_potentials(*_j(a, x, b, y))
    assert float(ts.max_diameter(*_t(x, y))) < 0.05
    _check_mass(f, fj, a, TOL)
    _check_mass(g, gj, b, TOL)


def test_sinkhorn_precomputed_cost_and_bad_scaling(rng):
    a, x, b, y = _clouds(rng)
    cost = ts.pairwise_l2(*_t(x, y))
    f0, g0 = ts.sinkhorn_potentials(*_t(a, x, b, y))
    f1, g1 = ts.sinkhorn_potentials(*_t(a, x, b, y), cost=cost, use_cost=True)
    np.testing.assert_array_equal(f0.numpy(), f1.numpy())
    np.testing.assert_array_equal(g0.numpy(), g1.numpy())
    with pytest.raises(ValueError, match="scaling"):
        ts.sinkhorn_potentials(*_t(a, x, b, y), scaling=1.0)
    with pytest.raises(ValueError, match="scaling"):
        sinkhorn_potentials_kernel(*_t(a, x, b, y), scaling=0.0)


def test_diameters_and_log_weights(rng):
    a, x, b, y = _clouds(rng)
    np.testing.assert_allclose(float(ts.max_diameter(*_t(x, y))),
                               float(js.max_diameter(*_j(x, y))), rtol=1e-6)
    for wa, wb in ((None, None), (a, b)):
        got = ts.pairwise_diameter(*_t(x, y), *(_t(wa, wb) if wa is not None
                                                else (None, None)))
        want = js.pairwise_diameter(*_j(x, y), *(_j(wa, wb) if wa is not None
                                                 else (None, None)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    w = np.array([[0.5, 0.0, 1e-35, -1.0, 1.0]], np.float32)
    np.testing.assert_allclose(ts.log_weights(torch.from_numpy(w)).numpy(),
                               np.asarray(js.log_weights(jnp.asarray(w))),
                               rtol=1e-6)
    assert float(ts.log_weights(torch.zeros(1))) == -1e5


def test_schedule_len_and_eps_at_exact():
    """Integer schedule lengths agree exactly; eps values to the last ulp or
    two of the two pow routines (rtol 1e-6)."""
    diam = np.array([0.001, 0.05, 0.051, 1.0, 7.3, 60.0, 0.0], np.float32)
    for blur, scaling in ((0.05, 0.9), (0.3, 0.5)):
        n_t = ts._schedule_len(torch.from_numpy(diam), blur, scaling)
        n_j = js._schedule_len(jnp.asarray(diam), blur, scaling)
        np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
        for i in (0, 1, 2, 5, int(n_t.max()) - 1, int(n_t.max())):
            e_t = ts._eps_at(i, torch.from_numpy(diam), blur, scaling, n_t)
            e_j = js._eps_at(jnp.int32(i), jnp.asarray(diam), blur, scaling, n_j)
            np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-6)


@pytest.mark.parametrize("diameter", ["global", "pair"])
def test_kernel_plain_version_matches_pallas_interpret(rng, diameter):
    a, x, b, y = _clouds(rng, bsz=6)
    f, g = sinkhorn_potentials_kernel(*_t(a, x, b, y), diameter=diameter)
    fj, gj = sinkhorn_potentials_pallas(*_j(a, x, b, y), diameter=diameter,
                                        interpret=True)
    _check_mass(f, fj, a, KTOL)
    _check_mass(g, gj, b, KTOL)
    # and against the port's own differentiable solver
    f2, g2 = ts.sinkhorn_potentials(*_t(a, x, b, y), diameter=diameter)
    _check_mass(f, f2, a, KTOL)
    _check_mass(g, g2, b, KTOL)


def test_kernel_wrapper_takes_cost_diameter_value_and_ragged_shapes(rng):
    a, x, b, y = _clouds(rng, bsz=3, n=4, m=9)
    cost = ts.pairwise_l2(*_t(x, y))
    f, g = sinkhorn_potentials_kernel(*_t(a, x, b, y), cost=cost, use_cost=True,
                                      diameter_value=torch.tensor(2.5))
    fj, gj = sinkhorn_potentials_pallas(
        *_j(a, x, b, y), diameter_value=jnp.float32(2.5), interpret=True)
    _check_mass(f, fj, a, KTOL)
    _check_mass(g, gj, b, KTOL)
    assert f.shape == (3, 4) and g.shape == (3, 9)
    assert not f.requires_grad


def test_kernel_wrapper_on_cpu_runs_plain_and_counts_no_launch(rng):
    a, x, b, y = _clouds(rng, bsz=2)
    cost = ts.pairwise_l2(*_t(x, y))
    la, lb = ts.log_weights(torch.from_numpy(a)), ts.log_weights(torch.from_numpy(b))
    diam = ts.resolve_diameter(*_t(x, y, a, b), "global", None)
    before = sinkhorn_solve.launches
    f, g = sinkhorn_solve(cost, la, lb, diam)
    fp, gp = sinkhorn_solve_plain(cost, la, lb, diam)
    assert sinkhorn_solve.launches == before
    np.testing.assert_array_equal(f.numpy(), fp.numpy())
    np.testing.assert_array_equal(g.numpy(), gp.numpy())


@pytest.mark.parametrize("n,m", [(48, 40), (100, 70)])
def test_kernel_plain_version_past_32_atoms_matches_pallas_interpret(rng, n, m):
    """Clouds past the 32 atoms one lane used to own: ragged n != m, floored
    pads (zero mass at the last atoms of each side)."""
    a, x, b, y = _clouds(rng, bsz=3, n=n, m=m, d=8)
    f, g = sinkhorn_potentials_kernel(*_t(a, x, b, y))
    fj, gj = sinkhorn_potentials_pallas(*_j(a, x, b, y), interpret=True)
    assert f.shape == (3, n) and g.shape == (3, m)
    _check_mass(f, fj, a, KTOL)
    _check_mass(g, gj, b, KTOL)


def test_what_the_cuda_wrapper_takes():
    """Which kernel takes a pair (`sinkhorn_route`): up to 32 atoms a side the
    small one (the cost in registers; shared memory holds two buffers of the
    32 + 32 values of h and a table of 128 rounds' log2(e) / eps and its
    reciprocal), up to 1024 atoms a side (registers) with the pair within one
    block's shared memory the wide one (the cost with an odd pitch and two
    rows of potentials), and every other pair the large one while its f, g
    and h fit a block's shared memory; past that the route raises."""
    assert pair_bytes(20, 20) == pair_bytes(32, 1) == 4 * (2 * (32 + 32) + 2 * 128)
    assert pair_bytes(48, 40) == 4 * (48 * 41 + 88)
    assert sinkhorn_route(20, 20) == sinkhorn_route(32, 32) == "small"
    assert sinkhorn_route(48, 40) == sinkhorn_route(100, 100) == "wide"
    assert sinkhorn_route(239, 239) == "wide" and sinkhorn_route(240, 240) == "large"
    assert sinkhorn_route(1, 1024) == "wide" and sinkhorn_route(1, 1025) == "large"
    assert sinkhorn_route(24, 1200) == sinkhorn_route(300, 300) == "large"
    assert large_bytes(24, 1200) == 8 * 1224
    assert sinkhorn_route(29_056 - 24, 24) == "large"
    with pytest.raises(ValueError, match="29033 x 24"):
        sinkhorn_route(29_033, 24)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_small_kernel_divided_softmin_is_closer_to_f64(seed, monkeypatch):
    """The small-pair kernel's arithmetic in numpy f32
    (test_torch_sinkhorn_order.kernel_order_solve) in its two softmin forms,
    on a scoring batch of `chip_smoke.case_sinkhorn`'s kind (B=4, 20 x 20
    sentences of 768-d reps, temp 5000, OT scores near -78): the OT scores
    of the divided form -- -(log2(sum) + max) / inv2, inv2 the rounded
    log2(e) / eps that scaled the terms -- are at least as close to the
    PyTorch solver in f64 as those of the multiplied form, -eps ln 2 *
    (log2(sum) + max), whose rounding of inv2 is common to every potential
    and grows ~1,560x at blur 0.05."""
    from aspire_tpu_torch.core.types import MultiVec
    from aspire_tpu_torch.ops import distances
    from test_torch_sinkhorn_order import kernel_order_solve
    gen = np.random.default_rng(seed)

    def side(smax=20, bsz=4, d=768):
        lens = gen.integers(4, smax + 1, bsz)
        emb = gen.standard_normal((bsz, smax, d)).astype(np.float32) * 2.0
        emb *= (np.arange(smax)[None, :] < lens[:, None])[:, :, None]
        return MultiVec(torch.from_numpy(emb), torch.from_numpy(lens))

    q, c = side(), side()
    cost = ts.pairwise_l2(q.embed, c.embed)
    a, b, _ = distances.ot_marginals(q, c, temp=5000.0, cost=cost)
    la, lb = ts.log_weights(a), ts.log_weights(b)
    diam = ts.resolve_diameter(q.embed, c.embed, a, b, "global", None)
    kw = dict(temp=5000.0, return_pair_sims=True)
    exact, _ = distances.wasserstein_dist(
        MultiVec(q.embed.double(), q.lens), MultiVec(c.embed.double(), c.lens),
        solver="torch", **kw)
    err = {}
    for divide in (False, True):
        f, g = kernel_order_solve(*(v.numpy() for v in (cost, la, lb, diam)),
                                  divide=divide)
        monkeypatch.setattr(distances, "sinkhorn_potentials_kernel",
                            lambda *_, **__: (torch.from_numpy(f), torch.from_numpy(g)))
        sims, _ = distances.wasserstein_dist(q, c, solver="kernel", **kw)
        err[divide] = float((sims.double() - exact).abs().max())
    assert float(exact.abs().max()) > 50.0
    assert err[True] <= err[False], err
