"""The int8 batched scan (K7) as csrc/scan_int8.cu computes it, written out
in numpy and PyTorch: the int8 -> bf16 upcast by integer and FP32-pipe
instructions, bit for bit for all 256 values; the k order in which a thread's
16 bytes are its A fragments, and the query laid out in that order, held
against `fused_l2max_scan_int8_batched` in interpret mode on the same numpy
inputs."""
import importlib.util
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.ops import pallas_scan as jscan
from aspire_tpu_torch.ops import _build, scan_kernel as sk


def byte_perm(x: np.ndarray, y, sel: int) -> np.ndarray:
    """PTX prmt (default mode, CUDA's __byte_perm): byte n of the result is
    byte (sel >> 4 n) & 7 of the eight bytes y:x (x the low four)."""
    pair = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(x, np.uint64)
    out = np.zeros(np.shape(x), np.uint64)
    for n in range(4):
        b = (sel >> (4 * n)) & 7
        out |= ((pair >> np.uint64(8 * b)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(np.uint32)


def int8x4_to_bf16x2(word: np.ndarray):
    """common.cuh's int8x4_to_bf16x2, instruction by instruction."""
    u = word ^ np.uint32(0x80808080)
    f = [byte_perm(u, 0x4B000000, 0x7440 + i).view(np.float32) - np.float32(8388736.0)
         for i in range(4)]
    lo = byte_perm(f[0].view(np.uint32), f[1].view(np.uint32), 0x7632)
    hi = byte_perm(f[2].view(np.uint32), f[3].view(np.uint32), 0x7632)
    return lo, hi


def test_upcast_by_bit_tricks_is_exact_for_every_int8():
    values = np.arange(-128, 128, dtype=np.int8)
    want = (torch.from_numpy(values).to(torch.bfloat16).view(torch.int16)
            .numpy().view(np.uint16))
    rng = np.random.default_rng(0)
    for pos in range(4):
        b = rng.integers(-128, 128, (256, 4)).astype(np.int8)
        b[:, pos] = values
        word = b.view(np.uint32)[:, 0]
        lo, hi = int8x4_to_bf16x2(word)
        halves = np.stack([lo & 0xFFFF, lo >> 16, hi & 0xFFFF, hi >> 16], axis=1)
        np.testing.assert_array_equal(halves[:, pos].astype(np.uint16), want)
        # every byte of the word lands in its own half: lo = bytes 0, 1; hi = 2, 3
        bf = (torch.from_numpy(b.astype(np.float32)).to(torch.bfloat16)
              .view(torch.int16).numpy().view(np.uint16))
        np.testing.assert_array_equal(halves.astype(np.uint16), bf)


@pytest.mark.parametrize("dp", [64, 128, 832])
def test_k_order_puts_a_threads_bytes_where_its_fragments_read(dp):
    """Thread t of a quad reads bytes 16 t .. 16 t + 15 of a row's 64-wide
    stage; word j of them is step j's A registers a0 (columns 2t, 2t+1) and a2
    (2t+8, 2t+9), so logical column 16 j + l must hold that byte."""
    order = sk.int8_k_order(dp).numpy()
    assert sorted(order.tolist()) == list(range(dp))
    for c in range(dp // 64):
        for t in range(4):
            for j in range(4):
                for e, l in enumerate((2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)):
                    assert order[64 * c + 16 * j + l] == 64 * c + 16 * t + 4 * j + e


def _kernel_model(sents, scales, norms, q, q_lens, qmax):
    """The scan as the CUDA kernel lays it out: the rows as stored, padded to
    a multiple of 64 and read in the k order its fragments give (`a`), the
    query through `int8_query_layout`, products of the exact bf16 operands in
    float64, then rs * acc + rb + qadd and the maxima."""
    n, s, d = sents.shape
    bsz = q.shape[0]
    qb = q.to(torch.bfloat16)                                    # never quantised
    qk = sk.int8_query_layout(qb.reshape(bsz * qmax, d))
    dp = qk.shape[1]
    order = sk.int8_k_order(dp)
    rows = torch.nn.functional.pad(sents.reshape(n * s, d), (0, dp - d))
    a = rows.to(torch.bfloat16)[:, order]                        # exact
    acc = a.double() @ qk.double().t()
    # the permutation changes no product
    plain = sents.reshape(n * s, d).double() @ qb.double().reshape(bsz * qmax, d).t()
    torch.testing.assert_close(acc, plain, rtol=1e-12, atol=1e-9)
    qf = q.float()
    valid = torch.arange(qmax)[None, :] < q_lens[:, None]
    qadd = torch.where(valid, -(qf * qf).sum(2), torch.full((bsz, qmax), sk.NEG))
    rs = (2.0 * scales).reshape(-1, 1).double()
    rb = torch.where(torch.isfinite(norms), -norms,
                     torch.full_like(norms, sk.NEG)).reshape(-1, 1).double()
    scores = rs * acc + rb + qadd.reshape(1, -1).double()
    return scores.reshape(n, s, bsz, qmax).amax(dim=(1, 3)).float()


@pytest.mark.parametrize("n,s,d,bsz,qmax", [(40, 12, 128, 4, 16),
                                            (64, 7, 96, 3, 5),
                                            (20, 24, 64, 1, 16),
                                            (32, 5, 160, 5, 20)])
def test_permuted_operands_give_the_pallas_kernel_scores(rng, n, s, d, bsz, qmax):
    sents = rng.integers(-127, 128, (n, s, d)).astype(np.int8)
    pad = rng.random((n, s)) < 0.25
    pad[n // 2] = True                                            # a doc of pads
    sents[pad] = 0
    scales = np.where(pad, 0.0, rng.uniform(0.005, 0.03, (n, s))).astype(np.float32)
    norms = (sents.astype(np.float32) ** 2).sum(2) * scales * scales
    norms[pad] = np.inf
    q = rng.normal(size=(bsz, qmax, d)).astype(np.float32)
    q_lens = rng.integers(1, qmax + 1, bsz).astype(np.int32)
    got = _kernel_model(torch.from_numpy(sents), torch.from_numpy(scales),
                        torch.from_numpy(norms), torch.from_numpy(q),
                        torch.from_numpy(q_lens), qmax).numpy()
    want = np.asarray(jscan.fused_l2max_scan_int8_batched(
        jnp.asarray(sents), jnp.asarray(scales), jnp.asarray(norms),
        jnp.asarray(q), jnp.asarray(q_lens), qmax=qmax, interpret=True))
    live = ~pad.all(axis=1)
    # float64 against the Pallas kernel's f32 sums of up to d products
    np.testing.assert_allclose(got[live], want[live], rtol=2e-4, atol=2e-4)
    assert (got[~live] <= -0.5e30).all() and (want[~live] <= -0.5e30).all()
    plain = sk.fused_l2max_scan_int8_batched_plain(
        torch.from_numpy(sents), torch.from_numpy(scales), torch.from_numpy(norms),
        torch.from_numpy(q), torch.from_numpy(q_lens), qmax).numpy()
    np.testing.assert_allclose(got[live], plain[live], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bsz,qmax,d,wide", [(32, 16, 768, True), (1, 16, 768, False),
                                             (5, 20, 768, True), (4, 16, 768, False),
                                             (8, 16, 768, True), (2, 64, 768, True),
                                             (32, 16, 800, False), (40, 16, 96, True)])
def test_int8_batches_go_to_the_wide_kernel_by_shape(bsz, qmax, d, wide):
    """Full column groups (128 columns) at D up to 768 run csrc/scan_int8.cu,
    whose group of [128, D] bf16 query rows stays in shared memory beside
    three 8 KB row stages, a tile's row maxima [128, 8], the unit's maxima
    [64, 8] and the barriers, within a block's 227 KB; the rest run
    csrc/scan.cu."""
    assert sk.scan_wide(bsz, qmax, d) is wide
    assert wide == (sk._tiling(bsz, qmax)[0] == sk.MAX_TILES and d <= 768)
    dp = -(-d // 64) * 64
    smem = 1024 + 128 * dp * 2 + 3 * 8192 + 128 * 8 * 4 + 64 * 8 * 4 + 7 * 8
    assert smem <= 232448 or not wide
    with pytest.raises(ValueError, match="query sentences"):
        sk._launch("aspire_scan_int8", torch.zeros((1, 1, d), dtype=torch.int8),
                   torch.zeros((1, 1)), torch.zeros((1, 1)),
                   torch.zeros((1, 129, d)), torch.zeros((1, 129)))


@pytest.mark.parametrize("d,tiles", [(768, 16), (864, 16), (896, 8), (1024, 8)])
def test_narrow_groups_fit_a_blocks_shared_memory(d, tiles):
    """csrc/scan.cu keeps a group's [8 tiles, D + 32] bf16 query rows in shared
    memory: past D = 864 a group holds 8 tiles, and a query at most 64
    sentences (a launch there used to be refused by the card)."""
    assert sk._max_tiles(d) == tiles
    assert sk._tiling(2, 64, tiles) == ((16, 8, 1, 2) if tiles == 16 else (8, 8, 2, 2))
    if tiles == 8:
        with pytest.raises(ValueError, match="up to 64 query sentences"):
            sk._launch("aspire_scan_int8", torch.zeros((1, 1, d), dtype=torch.int8),
                       torch.zeros((1, 1)), torch.zeros((1, 1)),
                       torch.zeros((1, 65, d)), torch.zeros((1, 65)))


def _column_owners(plan, unit):
    """The query each column of the packed groups holds (-1: a pad unit), from
    the plan's units and `unit_columns`' places."""
    groups = int(plan[0])
    units = plan[sk.PLAN_HEAD:].long().reshape(groups, sk.UNITS)
    owner = torch.full((groups, 128), -1, dtype=torch.long)
    owner[:, sk.unit_columns(unit)] = units.repeat_interleave(4, dim=1)
    return owner.reshape(-1)


def _packed_scores(sents, scales, norms, q, q_lens, qmax, unit):
    """The wide kernel's scores walked from its packed operands
    (`pack_queries_plain`): float64 products of the packed bf16 columns, then
    per row each query's maximum over its own columns (the plan's), + rb, and
    per document the maximum over its rows."""
    n, s, d = sents.shape
    bsz = q.shape[0]
    qf = q.float()
    packed, qa, plan = sk.pack_queries_plain(qf, -(qf * qf).sum(dim=2), q_lens, unit=unit)
    order = sk.int8_k_order(packed.shape[1])
    rows = torch.nn.functional.pad(sents.reshape(n * s, d), (0, packed.shape[1] - d))
    acc = rows.to(torch.bfloat16)[:, order].double() @ packed.double().t()
    v = (2.0 * scales).reshape(-1, 1).double() * acc + qa.double()
    rb = torch.where(torch.isfinite(norms), -norms, torch.full_like(norms, sk.NEG))
    owner = _column_owners(plan, unit)
    out = torch.full((n * s, bsz), -torch.inf, dtype=torch.float64)
    for b in range(bsz):
        out[:, b] = v[:, owner == b].amax(dim=1)
    out = out + rb.reshape(-1, 1).double()
    return out.reshape(n, s, bsz).amax(dim=1).float()


@pytest.mark.parametrize("unit", [4, 8])
@pytest.mark.parametrize("q_lens,qmax", [
    ([1, 3, 8, 9, 16, 17, 24], 24),                # ragged, 1 to 6 units a query
    ([0, 24, 2, 0, 9, 24, 24, 7], 24),             # empty queries hold a unit of pads
    ([16] * 32, 16), ([32] * 8, 32), ([64] * 5, 64), ([128] * 3, 128),   # all full
    ("b32", 24),                                   # 32 abstracts' queries, 3-20 sentences
    ([1] * 20 + [4] * 20, 24),                     # groups of 16 queries at most
    ([300 % 64 or 64] * 3 + [64] * 12, 64),        # full-text groups of 64 and their tails
])
def test_packing_gives_each_real_sentence_one_column(q_lens, qmax, unit):
    """The wide kernel's packed columns (`pack_plan`, `pack_queries_plain`):
    every real sentence in exactly one column, its query's, shared with none;
    pad columns zero with qadd -1e30; a query's units neighbours in one group,
    at most 16 queries a group; at most the groups of a query a power of two
    of columns (`launch_plan`'s bound, which sizes the buffers), and a batch
    of full power-of-two queries takes that layout's groups and columns, in
    the order of `unit_columns`.  The scores walked from the packed operands
    equal the plain version's."""
    rng = np.random.default_rng(7)
    if q_lens == "b32":
        q_lens = np.clip(rng.poisson(9, 32), 3, 20).tolist()
    bsz, d = len(q_lens), 96
    q = torch.from_numpy(rng.normal(size=(bsz, qmax, d)).astype(np.float32))
    qadd = torch.from_numpy(rng.normal(size=(bsz, qmax)).astype(np.float32))
    packed, qa, plan = sk.pack_queries_plain(q, qadd, q_lens, unit=unit)
    groups = int(plan[0])
    lens = [min(n, qmax) for n in q_lens]
    units = plan[sk.PLAN_HEAD:].reshape(groups, sk.UNITS)
    assert plan[:sk.PLAN_HEAD].tolist() == [groups, 128 * groups, sum(lens)]
    assert units.tolist() == sk.pack_plan(q_lens, qmax, unit)
    bound = sk.launch_plan(torch.int8, 100, 12, 768, bsz, qmax).groups
    assert groups <= bound
    owner = _column_owners(plan, unit)
    # the columns in stored order: which query and sentence each holds
    cols = packed.float()[:, torch.argsort(sk.int8_k_order(packed.shape[1]))][:, :d]
    real = {tuple(q[i, j].to(torch.bfloat16).float().tolist()): (i, j)
            for i in range(bsz) for j in range(lens[i])}
    seen = {}
    for c in range(groups * 128):
        hit = real.get(tuple(cols[c].tolist()))
        if hit is None or hit[0] != int(owner[c]):
            assert qa[c] == sk.NEG and not cols[c].any(), c
            continue
        assert hit not in seen and qa[c] == qadd[hit]
        seen[hit] = c
    assert sorted(seen) == [(i, j) for i in range(bsz) for j in range(lens[i])]
    # a query's units are neighbours in one group: ceil(len / unit) units of
    # `unit` columns, one at 0
    for i in range(bsz):
        where = (units == i).nonzero()
        assert where[:, 0].unique().numel() == 1
        assert where[:, 1].tolist() == list(range(where[0, 1], where[0, 1] + max(
            1, -(-lens[i] // unit)) * (unit // 4)))
    assert all(len(set(g) - {-1}) <= sk.SLOTS for g in units.tolist())
    if all(n == qmax for n in q_lens) and qmax >= 16 and qmax & (qmax - 1) == 0:
        _, tiles_q, old_groups, _ = sk._tiling(bsz, qmax)
        assert groups == old_groups
        per = 16 // tiles_q                        # queries a group
        place = sk.unit_columns(unit)
        assert all(seen[(i, j)] == 128 * (i // per) + int(place[8 * tiles_q * (i % per) + j])
                   for i, j in seen)
    n, s = 24, 5
    sents = torch.from_numpy(rng.integers(-127, 128, (n, s, d)).astype(np.int8))
    scales = torch.from_numpy(rng.uniform(0.005, 0.03, (n, s)).astype(np.float32))
    norms = (sents.float() ** 2).sum(2) * scales * scales
    norms[3] = np.inf                                        # a doc of pads
    got = _packed_scores(sents, scales, norms, q, torch.tensor(q_lens), qmax, unit)
    want = sk.fused_l2max_scan_int8_batched_plain(sents, scales, norms, q,
                                                  torch.tensor(q_lens), qmax)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("s,bsz,qmax,unit", [
    (12, 32, 24, 4), (24, 32, 16, 4), (12, 32, 128, 8), (1200, 8, 64, 8), (300, 8, 64, 8),
])
def test_pack_unit_follows_the_kernels_epilogue(s, bsz, qmax, unit):
    """Units of 4 columns for the short epilogue (documents of 12 or 24 rows),
    8-column tiles for the long one (a query of 128 columns, full-text rows)."""
    plan = sk.launch_plan(torch.int8, 1000, s, 768, bsz, qmax)
    assert sk.pack_unit(plan, s) == unit


def _ablation():
    path = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / \
        "torch_scan_int8_ablation.py"
    spec = importlib.util.spec_from_file_location("torch_scan_int8_ablation", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", ["as_built", "no_row_pass", "no_doc_pass", "no_epilogue",
                                     "no_products", "rows_only"])
def test_ablation_variants_find_their_text_in_the_kernel(variant):
    """benchmarks/torch_scan_int8_ablation.py builds its timing probes by text
    substitution in csrc/scan_int8.cu: each text it replaces is there, once."""
    source = (_build.CSRC / "scan_int8.cu").read_text()
    for old, new in _ablation().VARIANTS[variant]:
        assert source.count(old) == 1, old
        assert new != old


def _short_row_pass(vals, owner):
    """csrc/scan_int8.cu's short-epilogue row pass, lane by lane, on one row's
    128 column values `vals` of a group whose 32 units hold `owner`: a lane t
    of the quad holds columns 8 j + 2 t, + 1 of each tile j; the pairs' reduce-
    scatter leaves it units 8 t + i; runs in the lane, the segmented scan of
    the lanes' last runs, and the stores of a query's maximum by the lane of
    its last unit.  -> {slot: maximum}, with the stores counted."""
    tile = [[max(vals[8 * j + 2 * t], vals[8 * j + 2 * t + 1]) for j in range(16)]
            for t in range(4)]
    v = [[max(tile[t][8 * (t & 1) + i], tile[t ^ 1][8 * (t & 1) + i]) for i in range(8)]
         for t in range(4)]
    masks = []
    for t in range(4):
        brk = endq = slot4 = 0
        nq, prev = 0, -1
        for u in range(32):
            o, nxt = owner[u], owner[u + 1] if u + 1 < 32 else -1
            if o >= 0 and o != prev:
                nq += 1
            if u // 8 == t:
                i = u % 8
                brk |= (i == 7 or nxt != o) << i
                endq |= (o >= 0 and nxt != o) << i
                slot4 |= ((nq - 1) & 15) << (4 * i)
            prev = o
        cont_in = t > 0 and owner[8 * t] >= 0 and owner[8 * t - 1] == owner[8 * t]
        b7 = brk & 0x7F
        single = b7 == 0
        lastm = 0xFF if single else 0xFF & ~((2 << (b7.bit_length() - 1)) - 1)
        masks.append((brk, endq, slot4, cont_in, single, lastm))
    y = [max([v[t][i] for i in range(8) if masks[t][5] >> i & 1]) for t in range(4)]
    fresh = [not (m[4] and m[3]) for m in masks]
    for d in (1, 2):
        yp, fp = y[:], fresh[:]                  # the shuffle reads before the writes
        for t in range(4):
            if t >= d and not fresh[t]:
                y[t], fresh[t] = max(y[t], yp[t - d]), fp[t - d]
    stores = {}
    for t in range(4):
        brk, endq, slot4, cont_in, _, _ = masks[t]
        m = y[t - 1] if cont_in else -np.inf
        for i in range(8):
            m = max(m, v[t][i])
            if brk >> i & 1:
                if endq >> i & 1:
                    slot = slot4 >> (4 * i) & 15
                    assert slot not in stores, "two lanes store one slot"
                    stores[slot] = m
                m = -np.inf
    return stores


@pytest.mark.parametrize("q_lens,qmax", [
    ("b32", 24), ([16] * 8, 16), ([32] * 4, 32), ([64] * 2, 64), ([128], 128),
    ([0, 24, 2, 0, 9, 24, 7], 24), ([1] * 16, 24), ([5, 30, 1, 40, 2], 64), ([3, 120], 128),
])
def test_short_row_pass_gives_each_querys_maximum(q_lens, qmax):
    """The short epilogue's row pass, modelled lane by lane, stores for every
    query of each packed group (units of 4 columns) the maximum over its own
    columns, once, whatever the runs: queries within a lane, across two, three
    or all four lanes, pad units between them."""
    rng = np.random.default_rng(11)
    if q_lens == "b32":
        q_lens = np.clip(rng.poisson(9, 32), 3, 20).tolist()
    place = sk.unit_columns(4).tolist()
    for g, owner in enumerate(sk.pack_plan(q_lens, qmax, 4)):
        queries = sorted(set(owner) - {-1})
        for _ in range(4):
            vals = rng.normal(size=128).tolist()
            want = {k: max(vals[place[c]] for c in range(128) if owner[c // 4] == b)
                    for k, b in enumerate(queries)}
            assert _short_row_pass(vals, owner) == want
