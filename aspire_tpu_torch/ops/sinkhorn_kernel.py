"""CUDA Sinkhorn solver: wrapper, launch count and plain version.

Replaces the TPU kernel ``aspire_tpu/ops/pallas_sinkhorn.py:_sinkhorn_kernel``
(entry point ``sinkhorn_potentials_pallas``): forward-only batched balanced
log-domain Sinkhorn with a per-pair eps schedule.  The CUDA source is
``csrc/sinkhorn.cu``; the whole annealing loop runs on chip -- one read of the
cost, one write of the potentials -- and each pair stops after its own
schedule length, which also removes the host-side read of the batch maximum
that the TPU version needs.  The loop is a chain of about 85 dependent rounds,
so at small batches its latency bounds it, not the card's rate.  Three
kernels share the schedule, chosen by shape (`sinkhorn_route`; between the
wide and the large kernel also by the batch), each with its own launch
count: pairs of up to 32 x 32 run one block a pair with
four threads a softmin, the cost in registers and base-2 exponentials
("small"); wider pairs up to 1024 atoms a side whose pair fits one block's
shared memory (239 x 239 does, 240 x 240 does not; an abstract's query
against full-text candidates up to 55 x 1,024) run one block a pair with the
cost in shared memory ("wide", `wide_plan`): a team of lanes for each atom
of the shorter side O walking its row, merged by shuffles, and a thread for
each atom of the longer side L walking its column, side by side, with one
block barrier a round (large ones at small batches, such as B=16 of 239 x
239, go to the large kernel); every other pair up to n + m = 29,056 ("large") runs
spread over a thread-block cluster of c <= 8 blocks (`cluster_plan` picks c
from the batch and the shape).  The blocks split the pair's longer side, each keeps its
slice of the cost in shared memory for the whole loop (or the rows that fit,
reading the rest from device memory each round), one walk a round serves both
softmins, and the partial softmins of the other side are merged across the
cluster through distributed shared memory (`csrc/sinkhorn.cu`'s header).

``extrapolate=False`` returns the loop's own potentials, before the final
step at eps = blur: the training loss takes that step in PyTorch, where
gradients flow (`ops.sinkhorn.sinkhorn_potentials(loop="kernel")`).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from . import _build
from .cdist import pairwise_l2
from .sinkhorn import log_weights, resolve_diameter

MAX_SMEM = 232_448   # shared memory of one block on the H100, bytes
MAX_SIDE = 1024      # the wide kernel's atoms a side
SMALL_SIDE = 32      # pairs up to 32 x 32 keep the cost in registers
TABLE = 128          # rounds whose eps the small-pair kernel tabulates
WIDE_THREADS = 1024  # threads a block of the wide-pair kernel at most
WIDE_TABLE = 160     # rounds whose eps the wide-pair kernel tabulates at most
WIDE_PER = 4         # L atoms a thread of the wide-pair kernel takes at most
TEAMS = (1, 2, 4, 8, 16, 32)
CHUNK = 16           # terms a thread of the wide and large kernels holds at once
# the plan's model of a round of the wide-pair kernel, in microseconds,
# fitted to benchmarks/torch_sinkhorn_wide_sweep.py on the H100: a
# fixed part (barriers, logs, stores) a wave of blocks, and the terms of both
# walks of every pair an SM holds
WIDE_ROUND_US = 0.6
WIDE_TERMS_PER_US = 20_000
SM_SMEM = 233_472    # shared memory of an SM, bytes


def pair_bytes(n: int, m: int) -> int:
    """The route's measure of one n x m pair in shared memory: up to 32
    atoms a side the small kernel's two buffers of h (32 floats a side each)
    and log2(e) / eps of 128 rounds with its reciprocal; above, the cost with
    an odd row pitch (m | 1) and one float an atom of either side, the
    wide route's limit (the first wide design's layout; every such pair has
    a `wide_layout` that fits)."""
    if max(n, m) <= SMALL_SIDE:
        return 4 * (2 * 2 * SMALL_SIDE + 2 * TABLE)
    return 4 * (n * (m | 1) + n + m)


def large_bytes(n: int, m: int) -> int:
    """The large route's limit, 8 (n + m) bytes within one block's shared
    memory (n + m <= 29,056): the range the first large-pair design took
    (its f, g and h of both sides), which the cluster kernel keeps."""
    return 8 * (n + m)


SMS = 132                 # streaming multiprocessors of the H100
CLUSTER_MAX = 8           # blocks a pair: the portable cluster size
CLUSTER_THREADS = 512     # threads a block of the large-pair kernel
# clusters of c blocks the H100 holds at once, one block an SM (512 threads
# of 128 registers fill its register file; `cluster_capacity` on the card,
# benchmarks/torch_sinkhorn_cluster_sweep.py)
CLUSTERS_AT_ONCE = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
# the plan's model of a round on one SM, in microseconds, fitted to
# benchmarks/torch_sinkhorn_cluster_sweep.py on the H100: the terms of both
# walks, the rows past the resident ones read twice from L2 or device
# memory, two cluster barriers and the merge
TERMS_PER_US = 18_000
READ_BYTES_PER_US = 10_000
ROUND_US = 3.3


class ClusterLayout(NamedTuple):
    """One block's shared memory of the large-pair kernel, in floats (the
    kernel's `cluster_layout`): the blocks split the longer side L into slices
    of at most `lw` atoms, each holds the other side O whole; the resident
    rows' O units run `team` lanes a softmin; the cost tile's rows have
    `pitch` floats; the tile starts at `tile`."""
    o_len: int
    l_len: int
    lw: int
    team: int
    pitch: int
    tile: int
    floats: int


def _pad16(x: int) -> int:
    return (x + 15) // 16 * 16


def team_for(rows: int, lw: int) -> int:
    """Lanes an O atom's softmin takes: the largest power of two up to 32
    whose `rows` teams fit the threads beside the slice's L atoms (at least
    a warp)."""
    avail = max(32, CLUSTER_THREADS - -(-lw // 32) * 32)
    team = 32
    while team > 1 and rows * team > avail:
        team //= 2
    return team


def cluster_layout(n: int, m: int, c: int, res_rows: int) -> ClusterLayout:
    """The layout for c blocks a pair and `res_rows` rows of O resident (the
    rest read from device memory each round)."""
    o_len, l_len = (n, m) if m >= n else (m, n)
    lw = -(-l_len // c)
    team = team_for(res_rows, lw)
    pitch = team * (-(-lw // team) | 1)         # team x an odd number
    # h of O, h of the slice, (max, sum) of O and of the slice, the merged
    # share of O's potentials, the slice's potentials
    tile = _pad16(o_len) + _pad16(lw) + 2 * o_len + 2 * lw + -(-o_len // c) + lw
    return ClusterLayout(o_len, l_len, lw, team, pitch, tile, tile + res_rows * pitch)


def _fits(lay: ClusterLayout) -> bool:
    return 4 * lay.floats <= MAX_SMEM


def cluster_fit(n: int, m: int, c: int) -> int | None:
    """Resident rows for c blocks a pair: every row of the slice where it
    fits one block's shared memory, else the most that do, a multiple of 4
    (the rest are read from device memory each round); None where not even
    the potentials fit."""
    o_len = min(n, m)
    if not _fits(cluster_layout(n, m, c, 0)):
        return None
    lay = cluster_layout(n, m, c, o_len)
    if _fits(lay):
        return o_len
    # a multiple of 4: the rows past them start a float4 of h
    res = min(o_len - 1, (MAX_SMEM // 4 - lay.tile) // (lay.lw | 1)) // 4 * 4
    while res > 0 and not _fits(cluster_layout(n, m, c, res)):
        res -= 4
    return res


def cluster_round_us(bsz: int, n: int, m: int, c: int, res_rows: int) -> float:
    """The plan's estimate of a round of the batch: its waves of clusters
    times a block's exponentials or the bytes of its rows past the resident
    ones (read twice), whichever is longer, and the barriers."""
    o_len, lw = min(n, m), -(-max(n, m) // c)
    work = max(2 * o_len * lw / TERMS_PER_US,
               8 * (o_len - res_rows) * lw / READ_BYTES_PER_US)
    return -(-bsz // CLUSTERS_AT_ONCE[c]) * (work + ROUND_US)


def cluster_plan(bsz: int, n: int, m: int) -> tuple[int, int]:
    """(blocks a pair c, resident rows) of the large-pair kernel for a
    batch of bsz n x m pairs: c at most 8, and B c at most the card's 132
    SMs where B and the shape allow; among those the c whose estimated round
    is shortest (`cluster_round_us`; the larger c on a tie)."""
    most = CLUSTER_MAX if bsz > SMS else max(1, min(CLUSTER_MAX, SMS // bsz))
    fits = {c: cluster_fit(n, m, c) for c in range(1, min(CLUSTER_MAX, max(n, m)) + 1)}
    fits = {c: fit for c, fit in fits.items() if fit is not None}
    allowed = [c for c in fits if c <= most] or list(fits)
    if not allowed:
        raise ValueError(f"no cluster of the large-pair kernel takes {n} x {m}")
    # min keeps the first of equal estimates: the larger c
    c = min(sorted(allowed, reverse=True),
            key=lambda c: cluster_round_us(bsz, n, m, c, fits[c]))
    return c, fits[c]


class WideLayout(NamedTuple):
    """One block's shared memory of the wide-pair kernel, in floats (the
    kernel's `wide_layout`): h of O at 0, h of L at `h_l`, then a table of
    `table` rounds' log2(e) / eps and its reciprocal, then the cost [O][pitch]
    at `tile`, O the shorter side."""
    o_len: int
    l_len: int
    h_l: int
    table: int
    pitch: int
    tile: int
    floats: int


def wide_layout(n: int, m: int, team: int) -> WideLayout:
    """The layout for O atoms of `team` lanes: h of L 16-byte aligned where
    one lane walks a row (it reads h in float4s); the pitch team x an odd
    number where that fits one block's shared memory (the teams' and the L
    threads' reads both free of bank conflicts), else L | 1, else L; the
    table what is left, up to WIDE_TABLE rounds."""
    o_len, l_len = min(n, m), max(n, m)
    h_l = -(-o_len // 4) * 4 if team == 1 else o_len
    tab = h_l + l_len
    room = MAX_SMEM // 4 - tab
    odd = team * (-(-l_len // team) | 1)
    pitch = next((p for p in (odd, l_len | 1) if o_len * p <= room), l_len)
    table = max(0, min((room - o_len * pitch) // 2, WIDE_TABLE))
    tile = tab + 2 * table
    return WideLayout(o_len, l_len, h_l, table, pitch, tile, tile + o_len * pitch)


def wide_threads(n: int, m: int, team: int) -> tuple[int, int]:
    """(threads of the O teams, threads of the L atoms) for O atoms of
    `team` lanes: whole warps, a thread an L atom up to the block's 1024."""
    o_len, l_len = min(n, m), max(n, m)
    o_thr = -(-o_len * team // 32) * 32
    return o_thr, min(-(-l_len // 32) * 32, WIDE_THREADS - o_thr)


@functools.lru_cache(maxsize=None)
def wide_plan(n: int, m: int) -> tuple[int, int]:
    """(team, threads) of the wide-pair kernel for an n x m pair: among the
    teams whose layout fits one block's shared memory and whose L threads
    take at most WIDE_PER atoms each, the one whose longest chain of
    16-term chunks a thread walks (an O lane's L / team terms, or an L
    thread's atoms of O terms each) is shortest, then the fewest threads
    (no shuffles, more blocks an SM: at 48 x 40 one lane an O atom read
    0.074 ms against 0.082 for two, the same chain; PERF.md)."""
    o_len, l_len = min(n, m), max(n, m)
    best = None
    for team in TEAMS:
        o_thr, nl = wide_threads(n, m, team)
        if nl < 32 or -(-l_len // nl) > WIDE_PER \
                or 4 * wide_layout(n, m, team).floats > MAX_SMEM:
            continue
        chunks = max(-(-l_len // (team * CHUNK)),
                     -(-l_len // nl) * -(-o_len // CHUNK))
        key = (chunks, o_thr + nl)
        if best is None or key < best[0]:
            best = (key, team, o_thr + nl)
    if best is None:
        raise ValueError(f"no layout of the wide-pair kernel takes {n} x {m}")
    return best[1], best[2]


def wide_round_us(bsz: int, n: int, m: int) -> float:
    """The plan's estimate of a round of the batch on the wide-pair kernel:
    the SMs' pairs in waves of the blocks an SM holds (threads, 64 registers
    a thread, shared memory), a fixed part a wave and the exponentials of
    every pair an SM holds."""
    team, threads = wide_plan(n, m)
    bytes_ = 4 * wide_layout(n, m, team).floats
    at_once = max(1, min(2048 // threads, 65536 // (64 * threads), SM_SMEM // (bytes_ + 1024)))
    per_sm = -(-bsz // SMS)
    return -(-per_sm // at_once) * WIDE_ROUND_US + per_sm * 2 * n * m / WIDE_TERMS_PER_US


def cluster_capacity(n: int, m: int, c: int, res_rows: int) -> int:
    """Clusters of the large-pair kernel the card holds at once for this
    layout (`cudaOccupancyMaxActiveClusters`; needs the card)."""
    got = _build.load().aspire_sinkhorn_cluster_capacity(n, m, c, res_rows)
    if got < 0:
        _build.check(-got, "aspire_sinkhorn_cluster_capacity")
    return got


@functools.lru_cache(maxsize=None)
def sinkhorn_route(n: int, m: int, bsz: int | None = None) -> str:
    """'small', 'wide' or 'large': which kernel takes an n x m pair (the
    first two by the shape: up to 32 atoms a side, then up to 1,024 within
    one block's shared memory); raises past the large route's limit
    (`large_bytes`: n + m <= 29,056).  Given the batch, a wide pair goes to
    the large kernel where the plans' estimates of a round put the cluster
    first (`wide_round_us` against `cluster_round_us`): large pairs at small
    batches, such as B=16 of 239 x 239 or 55 x 1,024, where a cluster of
    blocks a pair beat a block a pair on the card (PERF.md)."""
    if max(n, m) <= SMALL_SIDE:
        return "small"
    if max(n, m) <= MAX_SIDE and pair_bytes(n, m) <= MAX_SMEM:
        if bsz is not None and cluster_round_us(bsz, n, m, *cluster_plan(bsz, n, m)) \
                < wide_round_us(bsz, n, m):
            return "large"
        return "wide"
    if large_bytes(n, m) <= MAX_SMEM:
        return "large"
    raise ValueError(f"the Sinkhorn kernels take pairs whose potentials fit one "
                     f"block's shared memory ({MAX_SMEM} bytes); {n} x {m} "
                     f"needs {large_bytes(n, m)}")


def sinkhorn_solve_plain(cost, log_a, log_b, diam, blur: float = 0.05,
                         scaling: float = 0.9, max_iters: int = 128,
                         extrapolate: bool = True):
    """Plain PyTorch version of the kernels, same arithmetic order (it
    multiplies by 1 / eps and takes eps from exp(k log s)), but for one step:
    the kernels divide each softmin's log-sum by the factor that scaled its
    terms, where this multiplies it by eps.

    cost f32[B, n, m], log_a f32[B, n], log_b f32[B, m], diam f32[B]
    -> (f [B, n], g [B, m]): after the final step at eps = blur, or with
    extrapolate=False the annealing loop's own potentials.
    """
    log_s = math.log(scaling)
    ratio = torch.log(blur / torch.clamp_min(diam, 1e-30)) / log_s
    lane_iters = torch.ceil(torch.clamp_min(ratio, 0.0)) + 2.0    # [B]
    d = torch.clamp_min(diam, 1e-12)

    def eps_at(i):
        k = float(max(i - 1, 0))
        return torch.where(i >= lane_iters - 1.0, torch.full_like(d, blur),
                           d * math.exp(k * log_s))[:, None]

    def softmin_m(eps, ce, h):      # over the m axis -> [B, n]
        return -eps * torch.logsumexp(h[:, None, :] - ce, dim=2)

    def softmin_n(eps, ce, h):      # over the n axis -> [B, m]
        return -eps * torch.logsumexp(h[:, :, None] - ce, dim=1)

    eps = eps_at(0)
    ce = cost * (1.0 / eps)[:, :, None]
    f = softmin_m(eps, ce, log_b)
    g = softmin_n(eps, ce, log_a)
    n_cap = min(int(lane_iters.max()), max_iters)
    for i in range(n_cap):
        eps = eps_at(i)
        inv = 1.0 / eps
        ce = cost * inv[:, :, None]
        ft = softmin_m(eps, ce, log_b + g * inv)
        gt = softmin_n(eps, ce, log_a + f * inv)
        live = (i < lane_iters)[:, None]
        f, g = (torch.where(live, 0.5 * (f + ft), f),
                torch.where(live, 0.5 * (g + gt), g))
    if not extrapolate:
        return f, g
    ce = cost * (1.0 / blur)
    return (softmin_m(blur, ce, log_b + g / blur),
            softmin_n(blur, ce, log_a + f / blur))


def sinkhorn_solve(cost, log_a, log_b, diam, blur: float = 0.05,
                   scaling: float = 0.9, max_iters: int = 128,
                   extrapolate: bool = True):
    """The kernel's wrapper: CUDA tensors launch it, CPU tensors run the
    plain version.  Same arguments and results as `sinkhorn_solve_plain`."""
    bsz, n, m = cost.shape
    if log_a.shape != (bsz, n) or log_b.shape != (bsz, m) or diam.shape != (bsz,):
        raise ValueError("log_a, log_b, diam must be [B, n], [B, m], [B]")
    if not cost.is_cuda:
        return sinkhorn_solve_plain(cost, log_a, log_b, diam, blur, scaling,
                                    max_iters, extrapolate)
    args = [t.detach().float().contiguous() for t in (cost, log_a, log_b, diam)]
    if any(t.device != cost.device for t in args):
        raise ValueError("all inputs must lie on the same device")
    f = torch.empty((bsz, n), dtype=torch.float32, device=cost.device)
    g = torch.empty((bsz, m), dtype=torch.float32, device=cost.device)
    if bsz == 0:
        return f, g
    route = sinkhorn_route(n, m, bsz)
    # the wide pairs: lanes an O atom, threads a block; the large ones:
    # blocks a pair, resident rows
    plan = (() if route == "small" else wide_plan(n, m) if route == "wide"
            else cluster_plan(bsz, n, m))
    name = {"small": "aspire_sinkhorn_f32", "wide": "aspire_sinkhorn_wide_f32",
            "large": "aspire_sinkhorn_large_f32"}[route]
    lib = _build.load()
    with torch.cuda.device(cost.device):
        err = getattr(lib, name)(
            *(t.data_ptr() for t in args), f.data_ptr(), g.data_ptr(),
            bsz, n, m, *plan, float(blur), math.log(scaling), int(max_iters),
            int(extrapolate), torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    counter = {"small": "launches", "wide": "wide_launches", "large": "large_launches"}[route]
    setattr(sinkhorn_solve, counter, getattr(sinkhorn_solve, counter) + 1)
    return f, g


# launches of the small-, wide- and large-pair kernels
sinkhorn_solve.launches = 0
sinkhorn_solve.wide_launches = 0
sinkhorn_solve.large_launches = 0


def sinkhorn_potentials_kernel(
    a: torch.Tensor, x: torch.Tensor, b: torch.Tensor, y: torch.Tensor,
    blur: float = 0.05, scaling: float = 0.9, max_iters: int = 128,
    cost: torch.Tensor | None = None, use_cost: bool = False,
    diameter: str = "global", diameter_value: torch.Tensor | None = None,
):
    """Forward-only replacement for sinkhorn_potentials (balanced case).

    a: [bsz, n]; x: [bsz, n, d]; b: [bsz, m]; y: [bsz, m, d].
    cost: optional precomputed f32[bsz, n, m] ground cost (use_cost=True).
    diameter: 'global' or 'pair'; either way the kernel receives a per-pair
    diameter computed here in plain PyTorch.
    Returns (f [bsz, n], g [bsz, m]) float32, without gradients.
    """
    if not 0.0 < scaling < 1.0:
        raise ValueError(f"scaling must be in (0, 1), got {scaling}")
    with torch.no_grad():
        c = cost.float() if use_cost else pairwise_l2(x, y)
        diam = resolve_diameter(x, y, a, b, diameter, diameter_value)
        return sinkhorn_solve(c, log_weights(a.float()), log_weights(b.float()),
                              diam, blur, scaling, max_iters)
