"""The large-pair Sinkhorn kernel's arithmetic (`sinkhorn_cluster_kernel` in
csrc/sinkhorn.cu), written out in numpy float32 and held against the kernel's
plain version and the JAX package's solvers, and the plan that launches it
(`ops/sinkhorn_kernel.cluster_plan`).

A pair is spread over a cluster of c blocks: the blocks split its longer side
L into slices [L r / c, L (r + 1) / c) and each holds the other side O whole.
A round walks each block's slice of O rows once (the resident rows first,
then those read from device memory): every L atom continues its (max, sum)
down its column, every O atom takes a partial over the slice by a team of
lanes (lane sub the atoms sub, sub + team, ...), merged by butterfly
shuffles.  A chain keeps 16 terms at a time: their max, one rescale of the
running sum, their exponentials summed as a tree; the terms past the last
full chunk form one more chunk of 8 or 16, padded with -inf.  The O atoms'
partials are merged over the blocks in rank order (the max first, then the
sum), and every softmin's log-sum is divided by the factor that scaled its
terms.  numpy has no fused
multiply-add and no ex2.approx, so the model holds the order, not the last
bit: `chip_smoke.py` holds the card's kernel against the plain version.

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
    CLUSTER_MAX, CLUSTERS_AT_ONCE, MAX_SMEM, SMS, cluster_fit, cluster_layout, cluster_plan,
    sinkhorn_route, sinkhorn_solve, sinkhorn_solve_plain, team_for)

from test_torch_sinkhorn import KTOL, _check_mass, _clouds, _j, _t

F32 = np.float32
LOG2E = F32(1.4426950408889634)
CHUNK = 16


def chunk(c, h, inv2, mx, s):
    """The kernel's `chunk`: N terms 2^(h - c inv2) along the last axis (-inf
    where masked) into (mx, s): their max, one rescale, a tree of sums."""
    t = (h - c * inv2[..., None]).astype(F32)
    top = np.maximum(mx, t.max(-1))
    e = np.exp2(t - top[..., None]).astype(F32)
    w = e.shape[-1] // 2
    while w:                                    # t[u] += t[u + w], w = N / 2 .. 1
        e = (e[..., :w] + e[..., w:2 * w]).astype(F32)
        w //= 2
    return top, (s * np.exp2(mx - top) + e[..., 0]).astype(F32)


def chain(c, h, inv2, mx, s):
    """The kernel's `chain` along the last axis of c and h, continuing
    (mx, s) [...]; inv2 [...]: full chunks of 16, then the rest as one
    chunk of 8 or 16 padded with -inf."""
    k_len = c.shape[-1]
    full = k_len // CHUNK * CHUNK
    for k in range(0, full, CHUNK):
        mx, s = chunk(c[..., k:k + CHUNK], h[..., k:k + CHUNK], inv2, mx, s)
    if full < k_len:
        width = CHUNK if k_len - full > CHUNK // 2 else CHUNK // 2
        pad = [(0, 0)] * (c.ndim - 1) + [(0, width - (k_len - full))]
        h_rest = np.broadcast_to(h[..., full:], c[..., full:].shape)
        mx, s = chunk(np.pad(c[..., full:], pad),
                      np.pad(h_rest, pad, constant_values=-np.inf), inv2, mx, s)
    return mx, s


def merge_part(m1, s1, m2, s2):
    """The kernel's `merge_part`: (max, sum) of two parts, (-inf, 0) empty."""
    top = np.maximum(m1, m2)
    with np.errstate(invalid="ignore"):
        s = (np.where(m1 == top, s1, s1 * np.exp2(m1 - top))
             + np.where(m2 == top, s2, s2 * np.exp2(m2 - top))).astype(F32)
    return top, s


def team_partials(c_rows, h_l, inv2, team):
    """O atoms' partials over one slice: c_rows [B, rows, lw], h_l [B, lw] ->
    lane 0's (max, sum) [B, rows] after the butterfly over `team` lanes."""
    bsz, rows, lw = c_rows.shape
    lanes_m = np.full((team, bsz, rows), -np.inf, F32)
    lanes_s = np.zeros((team, bsz, rows), F32)
    for sub in range(min(team, lw)):
        lanes_m[sub], lanes_s[sub] = chain(
            c_rows[:, :, sub::team], h_l[:, None, sub::team],
            np.broadcast_to(inv2[:, None], (bsz, rows)),
            lanes_m[sub], lanes_s[sub])
    w = 1
    while w < team:
        other = np.arange(team) ^ w
        lanes_m, lanes_s = merge_part(lanes_m, lanes_s, lanes_m[other], lanes_s[other])
        w <<= 1
    return lanes_m[0], lanes_s[0]


def cluster_order_solve(cost, log_a, log_b, diam, c, res_rows=None, blur=0.05,
                        scaling=0.9, max_iters=128, extrapolate=True):
    """numpy float32 model of sinkhorn_cluster_kernel -> (f [B, n], g [B, m])
    for c blocks a pair and res_rows of O resident (all by default): the
    resident rows' walk, then the rest's (read from device memory), each
    with its team of lanes for the O atoms."""
    cost, log_a, log_b, diam = (np.asarray(v, F32) for v in (cost, log_a, log_b, diam))
    bsz, n, m = cost.shape
    by_cols = m >= n                             # O the rows, L the columns
    c_ol = cost if by_cols else cost.transpose(0, 2, 1)
    lw_o, lw_l = (log_a, log_b) if by_cols else (log_b, log_a)
    o_len, l_len = c_ol.shape[1:]
    res_rows = o_len if res_rows is None else res_rows
    lw = -(-l_len // c)
    passes = [(o0, o1, team_for(o1 - o0, lw))
              for o0, o1 in ((0, res_rows), (res_rows, o_len)) if o1 > o0]
    bounds = [l_len * r // c for r in range(c + 1)]

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
        parts_m, parts_s, v_l = [], [], np.empty((bsz, l_len), F32)
        for r in range(c):
            a, b = bounds[r], bounds[r + 1]
            ml = np.full((bsz, b - a), -np.inf, F32)
            sl = np.zeros((bsz, b - a), F32)
            pm = np.empty((bsz, o_len), F32)
            ps = np.empty((bsz, o_len), F32)
            for o0, o1, team in passes:
                tile = c_ol[:, o0:o1, a:b]
                ml, sl = chain(tile.transpose(0, 2, 1), h_o[:, None, o0:o1],
                               np.broadcast_to(inv2[:, None], ml.shape), ml, sl)
                pm[:, o0:o1], ps[:, o0:o1] = team_partials(tile, h_l[:, a:b], inv2, team)
            v_l[:, a:b] = (-(np.log2(sl) + ml) / inv2[:, None]).astype(F32)
            parts_m.append(pm)
            parts_s.append(ps)
        top = np.max(parts_m, axis=0)
        total = np.zeros_like(top)
        for pm, ps in zip(parts_m, parts_s):      # in rank order
            total = (total + np.where(pm == top, ps, ps * np.exp2(pm - top))).astype(F32)
        v_o = (-(np.log2(total) + top) / inv2[:, None]).astype(F32)
        return v_o, v_l

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


# (n, m, c, resident rows): c = 7 divides no side; then slices partly or
# wholly read from device memory in each orientation (300 x 256 splits the rows)
LAYOUTS = [(240, 240, 7, None), (24, 1100, 7, None), (300, 256, 7, None),
           (240, 240, 3, 100), (24, 1100, 5, 8), (300, 256, 2, 60), (240, 240, 4, 0)]
IDS = [f"{n}x{m}_c{c}" + ("" if r is None else f"_res{r}") for n, m, c, r in LAYOUTS]


@pytest.mark.parametrize("n,m,c,res,extrapolate", [
    (*layout, e) for i, layout in enumerate(LAYOUTS) for e in (True, False)[:1 + (i < 3)]],
    ids=[f"{name}-{e}" for i, name in enumerate(IDS)
         for e in ("extrapolated", "loop_only")[:1 + (i < 3)]])
def test_cluster_order_matches_the_plain_version(rng, n, m, c, res, extrapolate):
    assert sinkhorn_route(n, m) == "large"
    (a, _, b, _), args = _inputs(rng, 2, n, m)
    f, g = cluster_order_solve(*(v.numpy() for v in args), c, res, extrapolate=extrapolate)
    fp, gp = sinkhorn_solve_plain(*args, extrapolate=extrapolate)
    _check_mass(f, fp, a, KTOL)
    _check_mass(g, gp, b, KTOL)


@pytest.mark.parametrize("n,m,c,res", LAYOUTS[:3], ids=IDS[:3])
def test_cluster_order_matches_pallas_interpret(rng, n, m, c, res):
    (a, x, b, y), args = _inputs(rng, 2, n, m)
    f, g = cluster_order_solve(*(v.numpy() for v in args), c, res)
    fj, gj = sinkhorn_potentials_pallas(*_j(a, x, b, y), diameter="pair", interpret=True)
    _check_mass(f, fj, a, KTOL)
    _check_mass(g, gj, b, KTOL)


@pytest.mark.parametrize("n,m,c,res", LAYOUTS[:3], ids=IDS[:3])
def test_cluster_order_loop_only_then_torch_step_matches_xla(rng, monkeypatch, n, m, c, res):
    """The training route: the model's loop-only potentials stand in for the
    kernel's under `sinkhorn_potentials(loop="kernel")`, whose final step
    runs in PyTorch, against the JAX package's XLA solver."""
    a, x, b, y = _clouds(rng, bsz=2, n=n, m=m, d=16)

    def model(cost, log_a, log_b, diam, blur, scaling, max_iters, extrapolate):
        assert not extrapolate
        f, g = cluster_order_solve(cost.numpy(), log_a.numpy(), log_b.numpy(),
                                   diam.numpy(), c, res, blur, scaling, max_iters,
                                   extrapolate=False)
        return torch.from_numpy(f), torch.from_numpy(g)

    monkeypatch.setattr(sk, "sinkhorn_solve", model)
    f, g = ts.sinkhorn_potentials(*_t(a, x, b, y), loop="kernel", diameter="pair")
    fj, gj = js.sinkhorn_potentials(*_j(a, x, b, y), diameter="pair")
    _check_mass(f.detach(), fj, a, KTOL)
    _check_mass(g.detach(), gj, b, KTOL)


# ------------------------------------------------------------------- the plan
def _large_shapes():
    """Shapes the route sends to the large kernel: its edges (a side past
    1,024, 240 x 240, n + m = 29,056) and a seeded sample in between."""
    shapes = [(240, 240), (1, 1025), (1025, 1), (24, 1200), (300, 1200), (1200, 300),
              (512, 512), (1200, 1200), (24, 29_032), (29_032, 24), (14_528, 14_528),
              (14_527, 14_529), (3000, 3000), (1, 29_055), (900, 28_156)]
    rng = np.random.default_rng(20)
    while len(shapes) < 60:
        n, m = (int(v) for v in rng.integers(1, 29_056, 2))
        if n + m <= 29_056 and sinkhorn_route(n, m) == "large":
            shapes.append((n, m))
    return shapes


@pytest.mark.parametrize("bsz", [1, 16, 20, 30, 160, 1024])
def test_the_plan_takes_every_large_shape(bsz):
    """Every shape of the large route gets a launch that fits one block's
    shared memory: c in [1, 8], at most one block a slice atom, res of the
    shorter side's rows resident (the rest read from device memory); B c at
    most the card's SMs where B and the shape allow (14,528 x 14,528 needs 6
    to 8 blocks a pair at any batch)."""
    for n, m in _large_shapes():
        assert sinkhorn_route(n, m) == "large"
        c, res = cluster_plan(bsz, n, m)
        assert 1 <= c <= min(CLUSTER_MAX, max(n, m))
        assert 0 <= res <= min(n, m) and (res == min(n, m) or res % 4 == 0)
        assert 4 * cluster_layout(n, m, c, res).floats <= MAX_SMEM
        if bsz <= SMS and any(cluster_fit(n, m, k) is not None
                              for k in range(1, SMS // bsz + 1)):
            assert bsz * c <= SMS


def test_the_fit_keeps_what_fits():
    """The slice is resident where it fits (24 x 1,200 at any c; 300 x 1,200
    from seven blocks a pair); else as many of its rows as fit beside the
    potentials, a multiple of 4 (1,200 x 1,200 at c = 8: four rows more would
    not); none where the potentials alone fill the block."""
    for c in range(1, 9):
        assert cluster_fit(24, 1200, c) == 24
    assert [cluster_fit(300, 1200, c) == 300 for c in range(1, 9)] == [False] * 6 + [True] * 2
    res = cluster_fit(1200, 1200, 8)
    assert 0 < res < 1200 and res % 4 == 0
    assert 4 * cluster_layout(1200, 1200, 8, res + 4).floats > MAX_SMEM
    assert cluster_fit(14_528, 14_528, 8) is not None and cluster_fit(14_528, 14_528, 5) is None


@pytest.mark.parametrize("bsz,n,m", [(16, 300, 1200), (20, 300, 1200), (16, 24, 1200),
                                     (16, 240, 240), (30, 300, 300), (16, 1200, 1200)])
def test_the_plan_runs_a_query_in_one_wave(bsz, n, m):
    """At a query's batches the clusters fit the card at once
    (`CLUSTERS_AT_ONCE`, measured on the H100)."""
    c, _ = cluster_plan(bsz, n, m)
    assert bsz <= CLUSTERS_AT_ONCE[c] and bsz * c <= SMS


@pytest.mark.parametrize("n,m", [(240, 240), (24, 1200), (300, 1200), (1200, 1200),
                                 (1, 1025), (300, 256), (29_032, 24)])
def test_the_tile_walks_are_free_of_bank_conflicts(n, m):
    """A warp's reads of the cost tile: 32 neighbouring L atoms of one row
    (L units), or 32 / team rows at team neighbouring L atoms (a step of the
    O units' teams) fall in 32 distinct banks; the pitch is team x an odd
    number and holds the slice."""
    for bsz in (1, 16, 160):
        lay = cluster_layout(n, m, *cluster_plan(bsz, n, m))
        assert lay.pitch >= lay.lw and lay.pitch % lay.team == 0
        assert (lay.pitch // lay.team) % 2 == 1
        for row in range(3):
            banks = {(row * lay.pitch + l) % 32 for l in range(32)}
            assert len(banks) == 32
        for k in range(3):
            banks = {(r * lay.pitch + sub + lay.team * k) % 32
                     for r in range(32 // lay.team) for sub in range(lay.team)}
            assert len(banks) == 32


def test_the_wrapper_launches_the_plan_without_a_transposed_copy(rng, monkeypatch):
    """The CUDA route of `sinkhorn_solve` on CPU tensors (the device and
    stream patched, the library recorded): one launch with the cost, the
    log-weights and the diameters as they are (no transposed copy), the plan's
    blocks a pair and resident rows, and one count."""
    _, args = _inputs(rng, 3, 24, 1100)
    calls = []

    def launch(*argv):
        calls.append(argv)
        return 0

    lib = types.SimpleNamespace(aspire_sinkhorn_large_f32=launch)
    monkeypatch.setattr(sk._build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(sinkhorn_solve, "large_launches", 0)
    with mock.patch.object(torch.Tensor, "is_cuda", new_callable=mock.PropertyMock,
                           return_value=True):
        f, g = sinkhorn_solve(*args)
    assert len(calls) == 1 and sinkhorn_solve.large_launches == 1
    argv = calls[0]
    assert list(argv[:4]) == [t.data_ptr() for t in args]
    assert argv[4:6] == (f.data_ptr(), g.data_ptr())
    assert argv[6:11] == (3, 24, 1100, *cluster_plan(3, 24, 1100))
    assert f.shape == (3, 24) and g.shape == (3, 1100)
