"""The wide-pair Sinkhorn kernel's arithmetic (`sinkhorn_wide_kernel` in
csrc/sinkhorn.cu), written out in numpy float32 and held against the kernel's
plain version and the JAX package's solvers, and the plan that launches it
(`ops/sinkhorn_kernel.wide_plan`, `wide_layout`).

A pair is one block.  Its cost lies in shared memory as [O][pitch], O the
shorter side.  A round walks the cost twice, side by side: every O atom by a
team of `team` lanes along its row (lane sub the L atoms sub, sub + team,
...), the lanes' (max, sum) merged by butterfly shuffles, and every L atom by
one thread down its column.  A walk is the large-pair kernel's chain (16
terms at a time: their max, one rescale of the running sum, their
exponentials summed as a tree; the rest one chunk of 8 or 16 padded with
-inf), and every softmin's log-sum is divided by the factor that scaled its
terms.  numpy has no fused multiply-add and no ex2.approx, so the model holds
the order, not the last bit: `chip_smoke.py` holds the card's kernel against
the plain version.

Tolerances: KTOL of test_torch_sinkhorn.py (1e-3) on the atoms with mass.
"""
import contextlib
import types
from unittest import mock

import numpy as np
import pytest
import torch

from aspire_tpu.ops import sinkhorn as js
from aspire_tpu.ops.pallas_sinkhorn import sinkhorn_potentials_pallas
from aspire_tpu_torch.ops import sinkhorn as ts
from aspire_tpu_torch.ops import sinkhorn_kernel as sk
from aspire_tpu_torch.ops.sinkhorn_kernel import (
    MAX_SIDE, MAX_SMEM, TEAMS, WIDE_PER, WIDE_TABLE, WIDE_THREADS, pair_bytes,
    sinkhorn_route, sinkhorn_solve, sinkhorn_solve_plain, wide_layout, wide_plan,
    wide_threads)

from test_torch_sinkhorn import KTOL, _check_mass, _clouds, _j, _t
from test_torch_sinkhorn_cluster import LOG2E, F32, chain, team_partials


def wide_order_solve(cost, log_a, log_b, diam, team=None, blur=0.05, scaling=0.9,
                     max_iters=128, extrapolate=True):
    """numpy float32 model of sinkhorn_wide_kernel -> (f [B, n], g [B, m])
    with O atoms of `team` lanes (the plan's by default)."""
    cost, log_a, log_b, diam = (np.asarray(v, F32) for v in (cost, log_a, log_b, diam))
    bsz, n, m = cost.shape
    team = wide_plan(n, m)[0] if team is None else team
    by_cols = m >= n                             # O the rows, L the columns
    tile = cost if by_cols else cost.transpose(0, 2, 1)     # [B, O, L]
    lw_o, lw_l = (log_a, log_b) if by_cols else (log_b, log_a)

    log_s = F32(np.log(scaling))
    ratio = np.log(F32(blur) / np.maximum(diam, F32(1e-30))) / log_s
    lane_iters = np.ceil(np.maximum(ratio, F32(0))) + F32(2)
    iters = np.minimum(lane_iters, F32(max_iters)).astype(np.int64)
    d_floor = np.maximum(diam, F32(1e-12))

    def inv2_of(eps):
        return ((F32(1) / eps) * LOG2E).astype(F32)

    def eps_at(i):
        k = F32(max(i - 1, 0))
        return np.where(i >= lane_iters - 1, F32(blur),
                        d_floor * np.exp(k * log_s).astype(F32)).astype(F32)

    def softmins(h_o, h_l, inv2):
        """One round -> (v over L for each O atom [B, O], v over O for each L atom [B, L])."""
        mo, so = team_partials(tile, h_l, inv2, team)
        ml = np.full(tile.shape[::2], -np.inf, F32)
        sl = np.zeros_like(ml)
        ml, sl = chain(tile.transpose(0, 2, 1), h_o[:, None, :],
                       np.broadcast_to(inv2[:, None], ml.shape), ml, sl)
        return ((-(np.log2(so) + mo) / inv2[:, None]).astype(F32),
                (-(np.log2(sl) + ml) / inv2[:, None]).astype(F32))

    lo2, ll2 = (lw_o * LOG2E).astype(F32), (lw_l * LOG2E).astype(F32)
    p_o, p_l = softmins(lo2, ll2, inv2_of(eps_at(0)))
    for it in range(int(iters.max())):
        inv2 = inv2_of(eps_at(it))
        v_o, v_l = softmins((lo2 + p_o * inv2[:, None]).astype(F32),
                            (ll2 + p_l * inv2[:, None]).astype(F32), inv2)
        live = (it < iters)[:, None]
        p_o = np.where(live, (F32(0.5) * (p_o + v_o)).astype(F32), p_o)
        p_l = np.where(live, (F32(0.5) * (p_l + v_l)).astype(F32), p_l)
    if extrapolate:
        inv2 = np.full(bsz, inv2_of(F32(blur)), F32)
        p_o, p_l = softmins((lo2 + p_o * inv2[:, None]).astype(F32),
                            (ll2 + p_l * inv2[:, None]).astype(F32), inv2)
    return (p_o, p_l) if by_cols else (p_l, p_o)


def _inputs(rng, bsz, n, m):
    a, x, b, y = _clouds(rng, bsz=bsz, n=n, m=m, d=16)
    cost = ts.pairwise_l2(*_t(x, y))
    la, lb = ts.log_weights(torch.from_numpy(a)), ts.log_weights(torch.from_numpy(b))
    diam = ts.resolve_diameter(*_t(x, y, a, b), "pair", None)
    return (a, x, b, y), (cost, la, lb, diam)


# (n, m, team): the plan's team at a square pair, both orientations of a thin
# one, an abstract's query against a full-text candidate; then teams the plan
# does not take here (32 lanes at 48 x 40, where 40 / 32 leaves lanes short)
SHAPES = [(48, 40, None), (100, 70, None), (20, 300, None), (300, 20, None),
          (20, 800, None), (48, 40, 32), (100, 70, 8)]
IDS = [f"{n}x{m}" + ("" if t is None else f"_team{t}") for n, m, t in SHAPES]


@pytest.mark.parametrize("n,m,team,extrapolate", [
    (*shape, e) for shape in SHAPES for e in (True, False)],
    ids=[f"{name}-{e}" for name in IDS for e in ("extrapolated", "loop_only")])
def test_wide_order_matches_the_plain_version(rng, n, m, team, extrapolate):
    assert sinkhorn_route(n, m) == "wide"
    (a, _, b, _), args = _inputs(rng, 2, n, m)
    f, g = wide_order_solve(*(v.numpy() for v in args), team, extrapolate=extrapolate)
    fp, gp = sinkhorn_solve_plain(*args, extrapolate=extrapolate)
    _check_mass(f, fp, a, KTOL)
    _check_mass(g, gp, b, KTOL)


@pytest.mark.parametrize("n,m", [(48, 40), (100, 70), (20, 300)])
def test_wide_order_matches_pallas_interpret(rng, n, m):
    (a, x, b, y), args = _inputs(rng, 2, n, m)
    f, g = wide_order_solve(*(v.numpy() for v in args))
    fj, gj = sinkhorn_potentials_pallas(*_j(a, x, b, y), diameter="pair", interpret=True)
    _check_mass(f, fj, a, KTOL)
    _check_mass(g, gj, b, KTOL)


@pytest.mark.parametrize("n,m", [(48, 40), (100, 70), (20, 300)])
def test_wide_order_loop_only_then_torch_step_matches_xla(rng, monkeypatch, n, m):
    """The training route: the model's loop-only potentials stand in for the
    kernel's under `sinkhorn_potentials(loop="kernel")`, whose final step
    runs in PyTorch, against the JAX package's XLA solver."""
    a, x, b, y = _clouds(rng, bsz=2, n=n, m=m, d=16)

    def model(cost, log_a, log_b, diam, blur, scaling, max_iters, extrapolate):
        assert not extrapolate
        f, g = wide_order_solve(cost.numpy(), log_a.numpy(), log_b.numpy(), diam.numpy(),
                                None, blur, scaling, max_iters, extrapolate=False)
        return torch.from_numpy(f), torch.from_numpy(g)

    monkeypatch.setattr(sk, "sinkhorn_solve", model)
    f, g = ts.sinkhorn_potentials(*_t(a, x, b, y), loop="kernel", diameter="pair")
    fj, gj = js.sinkhorn_potentials(*_j(a, x, b, y), diameter="pair")
    _check_mass(f.detach(), fj, a, KTOL)
    _check_mass(g.detach(), gj, b, KTOL)


# ------------------------------------------------------------------- the plan
def _edge_shapes():
    """The route's edges: for every longer side L of 33 to 1,024, the
    widest shorter side that the route still sends to the wide kernel, in
    both orientations."""
    shapes = []
    for l_len in range(33, MAX_SIDE + 1):
        for n_of in (lambda o: (o, l_len), lambda o: (l_len, o)):
            o = min(l_len, (MAX_SMEM // 4) // (l_len + 2) + 2)
            while o > 1 and pair_bytes(*n_of(o)) > MAX_SMEM:
                o -= 1
            shapes.append(n_of(o))
    return shapes


def _check_plan(n, m):
    team, threads = wide_plan(n, m)
    o_thr, nl = wide_threads(n, m, team)
    lay = wide_layout(n, m, team)
    assert team in TEAMS and threads == o_thr + nl <= WIDE_THREADS
    assert threads % 32 == 0 and o_thr >= min(n, m) * team and nl >= 32
    assert -(-max(n, m) // nl) <= WIDE_PER
    assert lay.pitch >= max(n, m) and 0 <= lay.table <= WIDE_TABLE
    assert lay.tile == lay.h_l + max(n, m) + 2 * lay.table
    assert lay.floats == lay.tile + min(n, m) * lay.pitch
    assert 4 * lay.floats <= MAX_SMEM
    if team == 1:
        assert lay.h_l % 4 == 0                 # h of L read in float4s
    return team, threads, lay


@pytest.mark.parametrize("n,m,team,threads", [
    (33, 1, 4, 96), (1, 33, 4, 96), (1, 1024, 32, 1024), (1024, 1, 32, 1024),
    (55, 1024, 8, 1024), (1024, 55, 8, 1024), (239, 239, 1, 512),
    (48, 40, 1, 128), (100, 100, 1, 256), (20, 800, 16, 1024), (20, 300, 16, 640)])
def test_the_plan_takes_every_shape_class(n, m, team, threads):
    """The route's classes: a side of one atom, the thin edge (55 x 1,024),
    the square edge (239 x 239), the serving shapes; 20 x 300 has a team of
    16 that does not divide its 300 L atoms.  Each has a launch that fits
    one block's shared memory, and the route sends it to the wide kernel."""
    assert sinkhorn_route(n, m) == "wide"
    assert _check_plan(n, m)[:2] == (team, threads)


def test_the_plan_takes_the_route_edges():
    """Every longer side from 33 to 1,024 at its widest shorter side, both
    orientations: the edges where the layout has the least room."""
    shapes = _edge_shapes()
    assert (55, 1024) in shapes and (1024, 55) in shapes and (239, 239) in shapes
    for n, m in shapes:
        assert sinkhorn_route(n, m) == "wide"
        _check_plan(n, m)


def test_the_table_holds_a_query_schedule():
    """Every round of a default schedule (128 iterations capped, with the
    first round and the final step) is tabulated at the serving and query
    shapes and at the edges 239 x 239 and 55 x 1,024; at 239 x 241 the
    rounds past the first 16 compute their eps, at 226 x 255 every round."""
    for n, m in [(48, 40), (100, 100), (20, 800), (239, 239), (55, 1024), (1, 1024)]:
        assert _check_plan(n, m)[2].table >= 130
    assert _check_plan(239, 241)[2].table == 16 and _check_plan(226, 255)[2].table == 0


@pytest.mark.parametrize("n,m", [(48, 40), (100, 70), (20, 800), (24, 1000), (33, 1),
                                 (1, 1024), (130, 130)])
def test_the_walks_are_free_of_bank_conflicts(n, m):
    """Where the pitch is team x an odd number: a step of an O team's warp
    (32 / team rows at team neighbouring L atoms) and a step of the L
    threads' warp (32 neighbouring L atoms of one row) fall in 32 distinct
    banks."""
    team, _, lay = _check_plan(n, m)
    assert lay.pitch % team == 0 and (lay.pitch // team) % 2 == 1
    for k in range(3):
        banks = {(r * lay.pitch + sub + team * k) % 32
                 for r in range(32 // team) for sub in range(team)}
        assert len(banks) == 32
    for row in range(3):
        assert len({(row * lay.pitch + l) % 32 for l in range(32)}) == 32


def test_the_wrapper_launches_the_plan(rng, monkeypatch):
    """The CUDA route of `sinkhorn_solve` on CPU tensors (the device and
    stream patched, the library recorded): one launch of the wide entry with
    the cost, the log-weights and the diameters as they are, the plan's team
    and threads, and one count on `wide_launches`, none on the others."""
    _, args = _inputs(rng, 3, 20, 300)
    calls = []

    def launch(*argv):
        calls.append(argv)
        return 0

    lib = types.SimpleNamespace(aspire_sinkhorn_wide_f32=launch)
    monkeypatch.setattr(sk._build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    for name in ("launches", "wide_launches", "large_launches"):
        monkeypatch.setattr(sinkhorn_solve, name, 0)
    with mock.patch.object(torch.Tensor, "is_cuda", new_callable=mock.PropertyMock,
                           return_value=True):
        f, g = sinkhorn_solve(*args, extrapolate=False)
    assert len(calls) == 1
    assert (sinkhorn_solve.launches, sinkhorn_solve.wide_launches,
            sinkhorn_solve.large_launches) == (0, 1, 0)
    argv = calls[0]
    assert list(argv[:4]) == [t.data_ptr() for t in args]
    assert argv[4:6] == (f.data_ptr(), g.data_ptr())
    assert argv[6:11] == (3, 20, 300, *wide_plan(20, 300))
    assert argv[-2] == 0                        # extrapolate off
    assert f.shape == (3, 20) and g.shape == (3, 300)


@pytest.mark.parametrize("bsz,n,m,route", [
    (16, 48, 40, "wide"), (1024, 48, 40, "wide"), (16, 100, 100, "wide"),
    (20, 20, 800, "wide"), (160, 20, 800, "wide"), (1, 20, 800, "wide"),
    (160, 239, 239, "wide"), (160, 55, 1024, "wide"),
    (16, 239, 239, "large"), (16, 55, 1024, "large"), (1, 239, 239, "large"),
    (4, 1024, 55, "large")])
def test_the_route_takes_the_cluster_where_it_wins(bsz, n, m, route):
    """Given the batch, a wide pair runs the kernel whose round the plans
    estimate shorter: the cluster for large pairs at small batches (on the
    card at B=16: 239 x 239 0.503 against 0.522 ms, 55 x 1,024 0.374 against
    0.567), a block a pair elsewhere (20 x 800 at B=20 0.266 against 0.308;
    at B=160 the cluster's waves make it 2.12 against 0.521)."""
    assert sinkhorn_route(n, m) == "wide"
    assert sinkhorn_route(n, m, bsz) == route


def test_the_wrapper_sends_a_large_wide_pair_to_the_cluster(rng, monkeypatch):
    """At B=16 a 239 x 239 pair launches the large-pair kernel with
    `cluster_plan`'s blocks a pair and resident rows, and counts there."""
    _, args = _inputs(rng, 16, 239, 239)
    calls = []
    lib = types.SimpleNamespace(aspire_sinkhorn_large_f32=lambda *argv: calls.append(argv) or 0)
    monkeypatch.setattr(sk._build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    for name in ("launches", "wide_launches", "large_launches"):
        monkeypatch.setattr(sinkhorn_solve, name, 0)
    with mock.patch.object(torch.Tensor, "is_cuda", new_callable=mock.PropertyMock,
                           return_value=True):
        sinkhorn_solve(*args)
    assert len(calls) == 1 and calls[0][6:11] == (16, 239, 239, *sk.cluster_plan(16, 239, 239))
    assert (sinkhorn_solve.wide_launches, sinkhorn_solve.large_launches) == (0, 1)
