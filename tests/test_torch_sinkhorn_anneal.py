"""Port parity: the training route through the Sinkhorn kernel's annealing
loop (loop-only mode, then the final step in PyTorch with gradients) against
the JAX package's XLA solver, on the same numpy inputs.

On CPU tensors the kernel's wrapper runs its plain version
(`sinkhorn_solve_plain(..., extrapolate=False)`), so these tests hold the
route's arithmetic; the CUDA kernel itself is held against the same plain
version on the card by `chip_smoke.py`.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.core.types import MultiVec as JMV
from aspire_tpu.ops import distances as jd
from aspire_tpu.ops import sinkhorn as js
from aspire_tpu_torch.core.config import ModelHParams as THP
from aspire_tpu_torch.core.types import MultiVec as TMV
from aspire_tpu_torch.models import bert as tb
from aspire_tpu_torch.models import doc_models as tdm
from aspire_tpu_torch.ops import distances as td
from aspire_tpu_torch.ops import sinkhorn as ts
from aspire_tpu_torch.ops.sinkhorn_kernel import sinkhorn_solve, sinkhorn_solve_plain

from test_torch_doc_models import FAMILIES, build_pair, make_batch, to_torch
from test_torch_sinkhorn import KTOL, _check_mass, _clouds, _j, _t

# The loop's potentials differ from the XLA solver's by the kernel form's
# arithmetic (1/eps products, eps from exp(k log s)); the final step and the
# gradients then agree as the plain route's do (test_torch_distances.py).
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


def _grouped(x, y, groups):
    return ts.grouped_max_diameter(*_t(x, y), groups)


CASES = {
    "global": dict(shape=dict()),
    "pair": dict(shape=dict(), kw=dict(diameter="pair")),
    "diameter_value": dict(shape=dict(), kw=dict(diameter_value=3.5)),
    "grouped": dict(shape=dict(bsz=6), groups=3),
    "ragged": dict(shape=dict(bsz=4, n=3, m=13)),
    "past_32_atoms": dict(shape=dict(bsz=3, n=48, m=40, d=8)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loop_only_plain_and_torch_extrapolation_match_jax(rng, case):
    spec = CASES[case]
    a, x, b, y = _clouds(rng, **spec["shape"])
    kw = dict(spec.get("kw", {}))
    if "groups" in spec:
        kw["diameter_value"] = _grouped(x, y, spec["groups"])
    jkw = {k: (jnp.asarray(np.asarray(v, np.float32)) if k == "diameter_value" else v)
           for k, v in kw.items()}
    before = sinkhorn_solve.launches
    f, g = ts.sinkhorn_potentials(*_t(a, x, b, y), loop="kernel", **kw)
    assert sinkhorn_solve.launches == before
    fj, gj = js.sinkhorn_potentials(*_j(a, x, b, y), **jkw)
    _check_mass(f, fj, a, KTOL)
    _check_mass(g, gj, b, KTOL)
    cost = ts.sinkhorn_cost(*_t(a), f, *_t(b), g)
    np.testing.assert_allclose(cost.numpy(), np.asarray(js.sinkhorn_cost(a, fj, b, gj)),
                               **KTOL)


def test_loop_only_mode_is_the_loop_before_the_final_step(rng):
    """extrapolate=False returns the plain loop's f and g; its final step
    taken by hand is extrapolate=True's result."""
    a, x, b, y = _clouds(rng, bsz=4)
    cost = ts.pairwise_l2(*_t(x, y))
    la, lb = ts.log_weights(torch.from_numpy(a)), ts.log_weights(torch.from_numpy(b))
    diam = ts.resolve_diameter(*_t(x, y, a, b), "global", None)
    f0, g0 = sinkhorn_solve_plain(cost, la, lb, diam, extrapolate=False)
    f1, g1 = sinkhorn_solve_plain(cost, la, lb, diam)
    ce = cost * (1.0 / 0.05)
    f_ext = -0.05 * torch.logsumexp((lb + g0 / 0.05)[:, None, :] - ce, dim=2)
    g_ext = -0.05 * torch.logsumexp((la + f0 / 0.05)[:, :, None] - ce, dim=1)
    np.testing.assert_array_equal(f_ext.numpy(), f1.numpy())
    np.testing.assert_array_equal(g_ext.numpy(), g1.numpy())
    # the loop of the differentiable solver, at the kernel form's tolerance
    ft, gt = ts._anneal(cost, cost.transpose(1, 2), la, lb, diam, 0.05, 0.9, 128,
                        lambda eps: 1.0)
    _check_mass(f0, ft, a, KTOL)
    _check_mass(g0, gt, b, KTOL)


def _pair(rng, bsz=6, sq=6, sc=7, d=16):
    qe = rng.normal(size=(bsz, sq, d)).astype(np.float32)
    ce = rng.normal(size=(bsz, sc, d)).astype(np.float32)
    ql = rng.integers(1, sq + 1, bsz).astype(np.int32)
    cl = rng.integers(1, sc + 1, bsz).astype(np.int32)
    qe *= (np.arange(sq)[None, :] < ql[:, None])[:, :, None]
    ce *= (np.arange(sc)[None, :] < cl[:, None])[:, :, None]
    return qe, ql, ce, cl


@pytest.mark.parametrize("grouped", [False, True], ids=["global", "grouped"])
def test_training_distance_and_gradient_through_the_kernel_loop_match_jax(rng, grouped):
    qe, ql, ce, cl = _pair(rng)
    diam = _grouped(qe, ce, 3) if grouped else None
    emb = torch.from_numpy(qe).requires_grad_(True)
    got = td.wasserstein_dist(TMV(emb, torch.from_numpy(ql)),
                              TMV(torch.from_numpy(ce), torch.from_numpy(cl)),
                              temp=5000.0, solver="kernel_loop", diameter_value=diam)
    got.sum().backward()
    jdiam = None if diam is None else jnp.asarray(diam.numpy())

    def jloss(e):
        return jd.wasserstein_dist(JMV(e, jnp.asarray(ql)),
                                   JMV(jnp.asarray(ce), jnp.asarray(cl)),
                                   temp=5000.0, diameter_value=jdiam)

    want = jloss(jnp.asarray(qe))
    jgrad = jax.grad(lambda e: jnp.sum(jloss(e)))(jnp.asarray(qe))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **KTOL)
    assert bool(torch.isfinite(emb.grad).all())
    np.testing.assert_allclose(emb.grad.numpy(), np.asarray(jgrad), **GRAD_TOL)


@pytest.mark.parametrize("pair_sims", [False, True])
def test_auto_on_the_cpu_is_torch_bit_for_bit_and_launches_nothing(rng, pair_sims):
    qe, ql, ce, cl = _pair(rng)
    q, c = TMV(*_t(qe, ql)), TMV(*_t(ce, cl))
    before = sinkhorn_solve.launches
    auto = td.wasserstein_dist(q, c, temp=5000.0, return_pair_sims=pair_sims)
    plain = td.wasserstein_dist(q, c, temp=5000.0, return_pair_sims=pair_sims,
                                solver="torch")
    assert sinkhorn_solve.launches == before
    for got, want in zip(jax.tree_util.tree_leaves(auto),
                         jax.tree_util.tree_leaves(plain)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_solver_routes():
    """'auto' takes the kernel's loop on CUDA tensors for balanced OT only;
    `reach` (unbalanced OT) is a configured route to the plain loop."""
    sel = td._select_solver
    assert sel("auto", None, True) == "kernel_loop"
    assert sel("auto", None, False) == "torch"
    assert sel("auto", 1.5, True) == "torch"
    assert sel("auto", 1.5, False) == "torch"
    for explicit in ("torch", "kernel", "kernel_loop"):
        assert sel(explicit, None, True) == sel(explicit, None, False) == explicit
    assert sel("torch", 1.5, True) == "torch"
    for kernel in ("kernel", "kernel_loop"):
        with pytest.raises(ValueError, match="balanced"):
            sel(kernel, 1.5, False)
    with pytest.raises(ValueError, match="solver"):
        sel("xla", None, False)
    with pytest.raises(ValueError, match="balanced"):
        ts.sinkhorn_potentials(*_t(*_clouds(np.random.default_rng(0))), reach=1.0,
                               loop="kernel")
    with pytest.raises(ValueError, match="loop"):
        ts.sinkhorn_potentials(*_t(*_clouds(np.random.default_rng(0))), loop="cuda")


def test_reach_takes_the_plain_loop_and_matches_jax(rng):
    qe, ql, ce, cl = _pair(rng)
    q, c = TMV(*_t(qe, ql)), TMV(*_t(ce, cl))
    got = td.wasserstein_dist(q, c, temp=5000.0, reach=1.5)
    np.testing.assert_array_equal(
        got.numpy(), td.wasserstein_dist(q, c, temp=5000.0, reach=1.5,
                                         solver="torch").numpy())
    want = jd.wasserstein_dist(JMV(*_j(qe, ql)), JMV(*_j(ce, cl)), temp=5000.0,
                               reach=1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-3)


def test_the_wrapper_refuses_bad_shapes(rng):
    a, x, b, y = _clouds(rng, bsz=2)
    cost = ts.pairwise_l2(*_t(x, y))
    la, lb = ts.log_weights(torch.from_numpy(a)), ts.log_weights(torch.from_numpy(b))
    diam = torch.ones(2)
    for bad in ((cost, la[:, :-1], lb, diam), (cost, la, lb[:1], diam),
                (cost, la, lb, torch.ones(3))):
        with pytest.raises(ValueError, match=r"\[B, n\]"):
            sinkhorn_solve(*bad, extrapolate=False)


def test_grouped_training_loss_through_the_kernel_loop_matches_jax(rng):
    """The slice as a whole on the CPU: the ts+otAspire model built on the
    kernel's loop (`ot_solver='kernel_loop'`) against the JAX model's grouped
    loss and gradients (XLA solver) -- loss at the kernel form's 1e-3, each
    parameter's gradient within 1e-3 of the larger of its norm and 1% of the
    whole gradient's norm."""
    name = "sbalisentbienc"
    jmodel, params, tmodel = build_pair(name, rng)
    kw = dict(FAMILIES[name], max_sents=tmodel.hp.max_sents)
    kmodel = tdm.build_model(THP(**kw), tb.BertConfig.tiny(**{
        "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}),
        device="cpu", ot_solver="kernel_loop")
    kmodel.load_state_dict(tmodel.state_dict())
    sb = make_batch(rng, lead=(2, 3), neg=True)
    (want, want_groups), want_grads = jax.value_and_grad(
        jmodel.train_loss_grouped, has_aux=True)(
            params, jax.tree.map(jnp.asarray, sb), jax.random.key(2), True)
    got, got_groups = kmodel.train_loss_grouped(to_torch(sb), None, True)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-3)
    np.testing.assert_allclose(got_groups.detach().numpy(), np.asarray(want_groups),
                               rtol=1e-3)
    from aspire_tpu_torch.models.convert import flax_params_from_model_state_dict
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in kmodel.named_parameters()}
    got_tree = dict(jax.tree_util.tree_leaves_with_path(
        flax_params_from_model_state_dict(grads, name)))
    want_tree = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, want_grads)))
    total = np.sqrt(sum(float((w ** 2).sum()) for w in want_tree.values()))
    for path, w in want_tree.items():
        scale = max(float(np.linalg.norm(w)), 1e-2 * total)
        assert float(np.abs(got_tree[path] - w).max()) <= 1e-3 * scale, path


def test_build_model_takes_the_solver_only_where_a_model_has_ot():
    cfg = tb.BertConfig.tiny()
    hp = THP(model_name="cospecter")
    with pytest.raises(ValueError, match="no OT distance"):
        tdm.build_model(hp, cfg, device="cpu", ot_solver="torch")
    assert tdm.build_model(hp, cfg, device="cpu") is not None
    hp = THP(model_name="sbalisentbienc", score_aggregation="l2wasserstein")
    with pytest.raises(ValueError, match="solver"):
        tdm.build_model(hp, cfg, device="cpu", ot_solver="pallas")
