"""CUDA first-stage corpus scans: wrappers, launch counts and plain versions.

Replace the two TPU kernels of ``aspire_tpu/ops/pallas_scan.py``:

  * ``_scan_kernel`` (entry point ``fused_l2max_scan``): one query against a
    bf16 bucket, per document the largest ``2 q.x - |x|^2`` over (sentence,
    query sentence);
  * ``_scan_int8_kernel`` (``fused_l2max_scan_int8_batched``): a batch of
    queries against an int8 bucket, rows upcast int8 -> bf16 (exact), the
    query rounded to bf16 and never quantised, f32 accumulation; per document
    and query the largest ``2 scale (q.x_i8) - |x|^2 - |q_j|^2``.

Both run ``csrc/scan.cu``'s kernel (its head says how it is laid out): the
[rows, columns] similarities stay in registers and only per-document maxima
reach device memory.  A single query is bound by the one read of the bucket;
a batch of 32 by the tensor cores: a query batch whose column groups are full
(`scan_wide`: 8 or more queries of up to 16 sentences, 4 of up to 32, ..., a
query of 65 or more sentences) runs ``csrc/scan_int8.cu`` instead, on int8
and on bf16 rows, a `wgmma` product fed by TMA from a query group kept in
shared memory.  That kernel reads each row's 64 bytes of a k stage in one
load a thread, so the query's k is permuted to match once a call
(`int8_k_order`); the sum over k is unchanged.  The choice is by shape alone.
`fused_l2max_scan` on float32 rows (the TPU kernel takes them too) runs
``csrc/scan.cu``'s f32 kernel: the true-f32 product by FMAs with the query in
f32, a check path.

The wide kernel computes only the batch's real query sentences: a query
takes ceil(q_len / 4) 4-column units (8-column tiles where the kernel's
epilogue is the long one: `pack_unit`), filled by its real sentences, and the
queries fill the 128-column groups in order, at most 16 a group
(`pack_plan`), none across two.  Its launch packs them on the device from the
lengths (`pack_kernel` in ``csrc/scan_int8.cu``; `pack_queries_plain` is its
plain version), so nothing is read on the host, and the grid, one persistent
block an SM, depends on no device value: each block reads the live groups
from the plan.  A batch of full queries of 16, 32, 64 or 128 sentences takes
the columns and groups of a query a power of two of columns (`_tiling`, which
also bounds the live groups and sizes the buffers).  The launch adds `columns` (128 a live group) and
`sentences` (the real ones) to the open `scan` span, device values read when
the records are.

A launch's unit of rows is a span of the bucket's flat rows (`span_rows`:
1,536 rows, or 64 whole documents where those are fewer), not a number of
documents, so a bucket of 840 documents of 1,200 sentences fills the card;
a document that straddles two spans is merged across them by an atomic max
in the output, which the wrapper fills with -inf first (`launch_plan` lays
out a launch: kernel, column groups, spans, grid).

`fused_l2max_scan` takes one argument the TPU kernel lacks, `qadd`: a term
added per query sentence *inside* the max.  The TPU kernel leaves "-|q|^2" to
its caller, which is right only while every query sentence has the same norm;
the index scorer (index/dense._bucket_topk) subtracts |q_j|^2 inside the max.
Without `qadd` the function is the TPU kernel (0 at valid query sentences,
-1e30 at padded ones); with ``qadd = -|q_j|^2`` it is what the index needs.

The TPU block rules (n % block_docs, D % 128, Qpad % 8) are gone: any n, any
S, any number of query sentences; the kernels need D % 32 == 0 and D <= 1024.
A query of more sentences than a kernel's column group holds (`query_cap`:
128, or 64 for bf16 and int8 rows wider than 864) is scored in groups of at
most that many rows (an int8 batch's in groups of half as many,
`int8_groups`), the groups joining the launch as extra queries (one launch a
bucket, which reads the rows from device memory once: the groups' blocks of
a span run side by side), and a query's score is the largest of its groups'
(`query_groups`, `fold_groups`): exact, the score being a maximum over query
sentences.  The CPU route groups the same way.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build
from ..utils import profiling

NEG = -1e30
MAX_TILES = 16        # 8-column tiles a block keeps in registers: 128 columns
MAX_DIM = 1024        # a group's query rows must fit a block's shared memory
K_STAGE = 64          # k a stage of the wide kernel on int8 rows (32 on bf16)
SPAN_ROWS = 1536      # rows a span: a block's (or a persistent block's step's) rows
SPAN_DOCS = 66        # documents a span may touch: the maxima a block keeps
WIDE_DIM = 768        # the wide kernel's widest D: its [128, D] bf16 query group


def _query_mask(qmax: int, q_lens: torch.Tensor) -> torch.Tensor:
    return torch.arange(qmax, device=q_lens.device)[None, :] < q_lens[:, None]


def fused_l2max_scan_plain(sents, q, norms, q_n: int, qadd=None) -> torch.Tensor:
    """Plain PyTorch version of `fused_l2max_scan`: the product in the
    bucket's dtype with f32 accumulation, written as a float32 product of the
    (exactly representable) rounded operands."""
    x = sents.float()
    qq = q.to(sents.dtype).float()
    sims = torch.einsum("nsd,qd->nsq", x, qq)
    scores = 2.0 * sims - norms[:, :, None]
    valid = torch.arange(q.shape[0], device=q.device) < q_n
    if qadd is not None:
        scores = scores + qadd.float()[None, None, :]
    scores = torch.where(valid[None, None, :], scores,
                         torch.full_like(scores, NEG))
    return scores.amax(dim=(1, 2))


def fused_l2max_scan_int8_batched_plain(sents, scales, norms, q, q_lens,
                                        qmax: int) -> torch.Tensor:
    """Plain PyTorch version of `fused_l2max_scan_int8_batched`."""
    n, s, d = sents.shape
    bsz = q.shape[0]
    qf = q.float()
    q_norms = (qf * qf).sum(dim=2)                               # [B, qmax]
    qadd = torch.where(_query_mask(qmax, q_lens), -q_norms,
                       torch.full_like(q_norms, NEG))
    qb = qf.to(torch.bfloat16).float().reshape(bsz * qmax, d)
    sims = torch.matmul(sents.reshape(n * s, d).float(), qb.t())
    rs = (2.0 * scales).reshape(n * s, 1)
    rb = torch.where(torch.isfinite(norms), -norms,
                     torch.full_like(norms, NEG)).reshape(n * s, 1)
    scores = rs * sims + rb + qadd.reshape(1, bsz * qmax)
    return scores.reshape(n, s, bsz, qmax).amax(dim=(1, 3))


def _pow2_at_least(x: int, floor: int) -> int:
    p = floor
    while p < x:
        p *= 2
    return p


def _tiling(bsz: int, qmax: int, max_tiles: int = MAX_TILES):
    """How a [bsz, qmax] batch of query sentences is laid over the kernel's
    column groups: (8-column tiles a group, tiles a query, groups, padded
    batch).  A query takes a power of two of columns (16 at least), a group a
    power of two of queries within `max_tiles` tiles, and the batch is padded
    to whole groups."""
    tiles_q = _pow2_at_least(qmax, 16) // 8
    per_group = min(_pow2_at_least(bsz, 1), max_tiles // tiles_q)
    groups = -(-bsz // per_group)
    return tiles_q * per_group, tiles_q, groups, groups * per_group


def _max_tiles(d: int) -> int:
    """8-column tiles a column group of csrc/scan.cu's bf16 and int8 kernel
    may hold: the group's [8 tiles, D + 32] bf16 query rows, qadd and the
    maxima live in a block's 227 KB of shared memory -- 16 tiles up to D = 864,
    8 past it."""
    smem = 8 * MAX_TILES * ((d + 32) * 2 + 4) + SPAN_DOCS * 8 * 4
    return MAX_TILES if smem <= 232448 else MAX_TILES // 2


PLAN_HEAD = 3          # the packing plan's header: live groups, their columns, real sentences
UNITS = 8 * MAX_TILES // 4   # 4-column units of a column group
SLOTS = 16             # queries a column group at most


def pack_unit(plan: "ScanPlan", s: int) -> int:
    """The columns a query's unit of the wide kernel's packing takes: 8 where
    its epilogue is the long one (documents of hundreds of rows, or a query a
    power of two of 128 columns: 8-column tiles), else 4 (csrc/scan_int8.cu's
    `long_walk`)."""
    long_walk = s * (plan.tiles_q // 2) >= 64 or plan.span != 64 * s
    return 8 if long_walk else 4


def pack_plan(q_lens, qmax: int, unit: int = 4) -> list[list[int]]:
    """The wide kernel's column layout of a batch whose query b holds
    q_lens[b] real sentences (clipped to [0, qmax]): per live column group
    the query each of its 32 units of 4 columns holds, -1 past them.  A
    query takes ceil(q_len / unit) units of `unit` columns (4 or 8: two
    units; one at q_len = 0) and the queries fill the groups in order, at
    most `SLOTS` a group, one that does not fit left opening the next, so
    none straddles two groups.  csrc/scan_int8.cu's `pack_kernel` lays out
    the same plan from the lengths on the device."""
    groups, used, held = [[-1] * UNITS], 0, 0
    for b, n in enumerate(q_lens):
        t = max(1, -(-min(max(int(n), 0), qmax) // unit)) * (unit // 4)
        if used + t > UNITS or held == SLOTS:
            groups.append([-1] * UNITS)
            used = held = 0
        groups[-1][used:used + t] = [b] * t
        used += t
        held += 1
    return groups


def unit_columns(unit: int = 4) -> torch.Tensor:
    """The column of a group that column e of unit u of `pack_plan` takes,
    at index 4 u + e: in order where units go by 8; where they go by 4, the
    half u // 16 of 8-column tile u % 16, so that the short epilogue's
    reduce-scatter leaves a lane 8 units in order."""
    u, e = torch.arange(UNITS).repeat_interleave(4), torch.arange(4).repeat(UNITS)
    return 4 * u + e if unit == 8 else 8 * (u % MAX_TILES) + 4 * (u // MAX_TILES) + e


def pack_buffers(groups: int, d: int, device) -> tuple:
    """The wide launch's packing buffers at the host's bound of `groups`
    column groups (`launch_plan`): packed bf16[groups * 128, Dp], qa
    f32[groups * 128], plan int32[PLAN_HEAD + groups * 16]; the kernel fills
    the live groups."""
    dp = -(-d // K_STAGE) * K_STAGE
    cols = groups * 8 * MAX_TILES
    return (torch.empty((cols, dp), dtype=torch.bfloat16, device=device),
            torch.empty(cols, dtype=torch.float32, device=device),
            torch.empty(PLAN_HEAD + groups * UNITS, dtype=torch.int32, device=device))


def pack_queries_plain(q, qadd, q_lens, width: int = K_STAGE, unit: int = 4):
    """Plain version of csrc/scan_int8.cu's `pack_kernel`: q f32[B, qmax, D],
    qadd f32[B, qmax] (read at real sentences), q_lens int[B] -> (packed
    [G * 128, Dp] of the real sentences rounded to bf16 in the k order of
    stages of `width` (`int8_query_layout`), zeros elsewhere; qa f32[G * 128],
    -1e30 at pad columns; plan int32[PLAN_HEAD + G * 32]: G, 128 G, the real
    sentences, then `pack_plan`'s units), the columns at `unit_columns`'
    places.  The kernel writes the live groups of buffers sized by
    `launch_plan`'s bound."""
    bsz, qmax, d = q.shape
    lens = [min(max(int(n), 0), qmax) for n in q_lens]
    units = pack_plan(lens, qmax, unit)
    width_g = 8 * MAX_TILES
    cols = torch.zeros((len(units) * width_g, d), dtype=torch.float32)
    qa = torch.full((len(units) * width_g,), NEG, dtype=torch.float32)
    place = unit_columns(unit)
    for g, owner in enumerate(units):
        for u, b in enumerate(owner):
            if b >= 0 and (u == 0 or owner[u - 1] != b):
                n = lens[b]
                at = g * width_g + place[4 * u:4 * u + n]
                cols[at] = q[b, :n].float()
                qa[at] = qadd[b, :n].float()
    head = [len(units), width_g * len(units), sum(lens)]
    plan = torch.tensor(head + [b for owner in units for b in owner], dtype=torch.int32)
    return int8_query_layout(cols.to(torch.bfloat16), width), qa, plan


def scan_wide(bsz: int, qmax: int, d: int) -> bool:
    """Whether a [bsz, qmax] query batch of width d runs the wide kernel
    (csrc/scan_int8.cu, int8 or bf16 rows): when its column groups are full
    -- 128 columns, 16 tiles, where the tensor cores bound the scan -- and
    the group's [128, D] bf16 query fits a block's shared memory beside the
    row stages (D up to 768).  Narrower batches (a single query of an
    abstract: one read of the rows bounds it) run csrc/scan.cu's kernel."""
    return _tiling(bsz, qmax)[0] == MAX_TILES and -(-d // K_STAGE) * K_STAGE <= WIDE_DIM


def span_rows(s: int) -> int:
    """Rows of a launch's span at S rows a document: 64 whole documents where
    they are at most SPAN_ROWS rows (S <= 24: the first kernels' blocks, read
    by their code), else SPAN_ROWS rows whatever S is, a span touching at
    most SPAN_ROWS // S + 2 documents.  On the card (NVIDIA H100, 700 W)
    spans of 1,024 and 1,536 rows read alike on documents of 1,200 rows, and
    2,048 up to 14% slower."""
    return 64 * s if 64 * s <= SPAN_ROWS else SPAN_ROWS


class ScanPlan(NamedTuple):
    """How one launch is laid out: the C entry, the column tiling of
    `_tiling`, the span (rows; the f32 kernel's unit is 64 whole documents),
    the spans and the grid's blocks."""
    kernel: str
    tiles: int
    tiles_q: int
    groups: int
    padded: int
    span: int
    spans: int
    blocks: int


def launch_plan(dtype: torch.dtype, n: int, s: int, d: int, bsz: int, qmax: int,
                sms: int = 132) -> ScanPlan:
    """The launch of a [bsz, qmax] query batch against a bucket [n, s, d] of
    `dtype` rows on a card of `sms` SMs.  bf16 and int8 rows: full column
    groups at d <= 768 go to the wide kernel, one persistent block an SM
    (every group one at least, at most one a span and group), whose packed
    groups (`pack_plan`: at most `groups`, the tiling of a query a power of
    two of columns) it counts on the device; the rest to csrc/scan.cu's
    kernel, one block a (span, group).  f32 rows: csrc/scan.cu's f32 kernel,
    one block a (64 documents, group)."""
    rows = n * s
    if dtype == torch.float32:
        tiles, tiles_q, groups, padded = _tiling(bsz, qmax, MAX_TILES)
        spans = -(-n // 64)
        return ScanPlan("aspire_scan_f32", tiles, tiles_q, groups, padded, 64 * s,
                        spans, groups * spans)
    kind = {torch.bfloat16: "bf16", torch.int8: "int8"}[dtype]
    span = span_rows(s)
    spans = -(-rows // span)
    if scan_wide(bsz, qmax, d):
        tiles, tiles_q, groups, padded = _tiling(bsz, qmax, MAX_TILES)
        return ScanPlan(f"aspire_scan_{kind}_wide", tiles, tiles_q, groups, padded, span,
                        spans, min(max(sms, groups), groups * spans))
    tiles, tiles_q, groups, padded = _tiling(bsz, qmax, _max_tiles(d))
    return ScanPlan(f"aspire_scan_{kind}", tiles, tiles_q, groups, padded, span, spans,
                    groups * spans)


def query_cap(dtype: torch.dtype, d: int) -> int:
    """Query sentences the scan kernels score in one column group at width
    d: 128 (16 tiles of 8 columns), or 64 for bf16 and int8 rows where a
    group's bf16 query rows fill a block's shared memory (`_max_tiles`)."""
    return 8 * (MAX_TILES if dtype == torch.float32 else _max_tiles(d))


def query_groups(q: torch.Tensor, cap: int):
    """q [B, Q, D] -> ([B * G, cap, D], G) with G = ceil(Q / cap): entry
    b G + g holds query b's rows g cap .. + cap - 1, zero rows past Q."""
    bsz, qn, d = q.shape
    groups = -(-qn // cap)
    padded = torch.nn.functional.pad(q, (0, 0, 0, groups * cap - qn))
    return padded.reshape(bsz * groups, cap, d), groups


def int8_groups(qmax: int, d: int):
    """(rows a group, groups a query) of an int8 batch's queries of qmax
    sentences: past `query_cap` a query is cut in groups of half the cap,
    two to a column group, so that the last pads at most cap / 2 - 1 rows
    (300 sentences: five groups of 64, 320 columns, where groups of 128
    pad to 384).  Within the cap, one group of qmax."""
    cap = query_cap(torch.int8, d)
    rows = qmax if qmax <= cap else cap // 2
    return rows, -(-qmax // rows)


def fold_groups(scores: torch.Tensor, groups: int) -> torch.Tensor:
    """[n, B * G] scores of `query_groups`' entries -> [n, B]: a query's
    score is the largest of its groups'."""
    return scores.reshape(scores.shape[0], -1, groups).amax(dim=2)


@functools.lru_cache(maxsize=None)
def int8_k_order(dp: int, device: str = "cpu", width: int = K_STAGE) -> torch.Tensor:
    """The wide kernel's k order, for a width dp (a multiple of 64) and a
    stage of `width` k (64 on int8 rows, 32 on bf16): position width c + 16 j
    + l holds the stored column width c + (width / 4) ((l % 8) // 2) + 4 j +
    (l % 2) + 2 (l // 8).  A thread's 16 bytes of a row's stage are its A
    fragments of the stage's k16 steps (int8, word j: step j's columns 2t,
    2t+1 and 2t+8, 2t+9 for the thread t of its quad; bf16, words 2j and 2j +
    1); the query, laid out in this order, meets each element at its own
    column."""
    j = torch.arange(width // 16)[:, None]
    lane = torch.arange(16)[None, :]
    phys = ((width // 4) * ((lane % 8) // 2) + 4 * j + lane % 2
            + 2 * (lane // 8)).reshape(-1)
    order = (torch.arange(dp // width)[:, None] * width + phys[None, :]).reshape(-1)
    return order.to(device)                 # kept per device: no copy a call


def int8_query_layout(q: torch.Tensor, width: int = K_STAGE) -> torch.Tensor:
    """The wide kernel's query operand: q [..., D] padded with zeros to a
    multiple of 64 and laid out in `int8_k_order` for stages of `width`."""
    d = q.shape[-1]
    dp = -(-d // K_STAGE) * K_STAGE
    order = int8_k_order(dp, str(q.device), width)
    return torch.nn.functional.pad(q, (0, dp - d))[..., order].contiguous()


def _launch(name: str, sents, scales, norms, q, qadd, q_lens=None,
            scratch=None) -> torch.Tensor:
    """sents [n, s, d] (bf16, int8 or f32), norms (and scales) f32[n, s], q
    f32[B, qmax, d], qadd f32[B, qmax] -> f32[n, B], by the kernel
    `launch_plan` picks for the rows of C entry `name` (aspire_scan_bf16,
    _int8 or _f32; its _wide form where the groups are full).  The query goes
    to the kernel in bf16, or in f32 for f32 rows.  csrc/scan.cu's kernels
    take qadd at -1e30 past each query's length; the wide kernel takes the
    lengths, int[B] on the device (q_lens), packs the real sentences itself
    and reads qadd at them alone, into `scratch` where given (`pack_buffers`:
    the packed query, its qadd and plan, as `pack_queries_plain` gives them
    for the live groups)."""
    n, s, d = sents.shape
    bsz, qmax, _ = q.shape
    if d % 32 or d > MAX_DIM:
        raise ValueError(f"the scan kernel takes a width that is a multiple "
                         f"of 32 up to {MAX_DIM}, got {d}")
    if n * s > 2**31 - 1:
        raise ValueError(f"the scan kernel takes up to 2^31 - 1 rows a bucket, got {n * s}")
    if qmax < 1 or qmax > 8 * MAX_TILES:
        raise ValueError(f"a launch of the scan kernel takes 1 to "
                         f"{8 * MAX_TILES} query sentences a query, got {qmax} "
                         f"(the wrappers score more in groups)")
    wide = sents.dtype != torch.float32 and scan_wide(bsz, qmax, d)
    # csrc/scan.cu's bf16 and int8 kernel keeps a group's query rows in shared
    # memory (its f32 kernel stages them in chunks)
    max_tiles = MAX_TILES if wide or sents.dtype == torch.float32 else _max_tiles(d)
    if qmax > 8 * max_tiles:
        raise ValueError(f"a launch of the scan kernel takes up to "
                         f"{8 * max_tiles} query sentences a query at width "
                         f"{d}, got {qmax} (the wrappers score more in groups)")
    rows = (norms,) if scales is None else (norms, scales)
    if any(t.shape != (n, s) or t.dtype != torch.float32 for t in rows):
        raise ValueError("norms and scales must be float32 [n, s]")
    if any(t.device != sents.device for t in (*rows, q, qadd)):
        raise ValueError("all inputs must lie on the same device")
    sms = torch.cuda.get_device_properties(sents.device).multi_processor_count
    plan = launch_plan(sents.dtype, n, s, d, bsz, qmax, sms)
    if plan.kernel.removesuffix("_wide") != name:
        raise ValueError(f"{name} does not take {sents.dtype} rows")
    dev = sents.device
    # a document that straddles two spans is merged into -inf by atomic max;
    # spans of whole documents store every maximum
    cols = bsz if wide else plan.padded
    out = torch.empty((n, cols), dtype=torch.float32, device=dev) \
        if plan.span % s == 0 else \
        torch.full((n, cols), -torch.inf, dtype=torch.float32, device=dev)
    if n == 0:
        return out[:, :bsz]
    sents, norms = sents.contiguous(), norms.contiguous()
    args = [sents.data_ptr()]
    if scales is not None:
        scales = scales.contiguous()
        args.append(scales.data_ptr())
    if sents.data_ptr() % 16:
        raise ValueError("the bucket's rows must start at a 16-byte boundary")
    lib = _build.load()
    if wide:
        if q_lens is None or q_lens.shape != (bsz,) or q_lens.device != dev:
            raise ValueError("the wide kernel takes the queries' lengths, int[B] on the device")
        if q_lens.dtype not in (torch.int32, torch.int64):
            q_lens = q_lens.long()
        q, qadd, q_lens = q.float().contiguous(), qadd.float().contiguous(), q_lens.contiguous()
        if scratch is not None and any(
                a.shape != b.shape or a.dtype != b.dtype or a.device != dev or
                not a.is_contiguous() for a, b in zip(scratch, pack_buffers(plan.groups, d, "meta"))):
            raise ValueError("scratch must be pack_buffers(launch_plan(...).groups, d) on the device")
        packed, qa, table = scratch or pack_buffers(plan.groups, d, dev)
        args += [norms.data_ptr(), q.data_ptr(), qadd.data_ptr(), q_lens.data_ptr(),
                 packed.data_ptr(), qa.data_ptr(), table.data_ptr(), out.data_ptr(), n, s, d,
                 bsz, qmax, int(q_lens.dtype == torch.int64), plan.tiles_q, plan.groups,
                 plan.span, plan.blocks]
        if profiling.tracing():
            # the columns the launch computes and the real sentences it scores
            profiling.count(columns=table[1], sentences=table[2])
    else:
        # pad columns hold zero rows and -1e30, so they never win a max
        qcols = 8 * plan.tiles_q
        q_dtype = torch.float32 if sents.dtype == torch.float32 else torch.bfloat16
        qp = torch.zeros((plan.padded, qcols, d), dtype=q_dtype, device=dev)
        qp[:bsz, :qmax] = q
        qa = torch.full((plan.padded, qcols), NEG, dtype=torch.float32, device=dev)
        qa[:bsz, :qmax] = qadd
        tail = (plan.tiles, plan.tiles_q, plan.groups, plan.padded)
        if sents.dtype != torch.float32:
            tail += (plan.span,)
        args += [norms.data_ptr(), qp.data_ptr(), qa.data_ptr(), out.data_ptr(), n, s, d, *tail]
    with torch.cuda.device(dev):
        err = getattr(lib, plan.kernel)(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(err, plan.kernel)
    return out[:, :bsz]


def fused_l2max_scan(sents, q, norms, q_n: int, qadd=None) -> torch.Tensor:
    """Per-document max-similarity scores of one query over one dense bucket.

    sents: [N, S, D] bf16 or f32; q: [Qpad, D] query sentence matrix, cast
    to the rows' dtype, the first `q_n` rows valid; norms: f32[N, S] squared
    sentence norms (+inf at pads); qadd: optional f32[Qpad] added per query
    sentence inside the max.  Returns f32[N]: max over (sentence, valid query
    sentence) of 2 q.x - |x|^2 (+ qadd); a document of pads only gives -inf
    (or -1e30 where padded query sentences exist).  CUDA tensors launch the
    kernel (bf16 rows: tensor cores, csrc/scan.cu's or, for a query of 65 or
    more sentences at D <= 768, csrc/scan_int8.cu's; f32 rows: true-f32
    FMAs); CPU tensors run the plain version.  More than `query_cap` query
    sentences are scored in groups: one launch whose extra queries they are
    (a plain call a group on the CPU).
    """
    qpad, cap = q.shape[0], query_cap(sents.dtype, sents.shape[-1])
    if qpad <= cap and not sents.is_cuda:
        return fused_l2max_scan_plain(sents, q, norms, q_n, qadd)
    if sents.is_cuda and sents.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the scan kernel takes bfloat16 or float32 rows, got "
                        f"{sents.dtype}")
    groups = 1 if qpad <= cap else -(-qpad // cap)
    rows = min(qpad, cap)
    wide = sents.is_cuda and sents.dtype == torch.bfloat16 and scan_wide(
        groups, rows, sents.shape[2])
    add = torch.zeros(qpad, dtype=torch.float32, device=q.device) \
        if qadd is None else qadd.float()
    if not wide:
        # csrc/scan.cu's kernels and the plain version take -1e30 past q_n;
        # the wide kernel reads qadd only below the groups' lengths
        valid = torch.arange(qpad, device=q.device) < q_n
        add = torch.where(valid, add, torch.full_like(add, NEG))
    if qpad <= cap:
        qg, ag = q.float()[None], add[None]
    else:
        qg, _ = query_groups(q.float()[None], cap)
        ag = torch.nn.functional.pad(add, (0, groups * cap - qpad),
                                     value=NEG).reshape(groups, cap)
    if not sents.is_cuda:
        return fold_groups(torch.stack([
            fused_l2max_scan_plain(sents, qg[i], norms, cap, ag[i])
            for i in range(groups)], dim=1), groups)[:, 0]
    names = {torch.bfloat16: "aspire_scan_bf16", torch.float32: "aspire_scan_f32"}
    # the groups' lengths, for the wide kernel's packing
    lens = (q_n - rows * torch.arange(groups, device=q.device)).clamp(0, rows) \
        if wide else None
    out = _launch(names[sents.dtype], sents, None, norms, qg, ag, lens)
    if groups > 1:
        out = fold_groups(out, groups)
    if wide:
        fused_l2max_scan.wide_launches += 1
    else:
        fused_l2max_scan.launches += 1
    return out[:, 0]


# launches of csrc/scan.cu's bf16 and f32 kernels and of csrc/scan_int8.cu's
# on bf16 rows
fused_l2max_scan.launches = 0
fused_l2max_scan.wide_launches = 0


def fused_l2max_scan_int8_batched(sents, scales, norms, q, q_lens,
                                  qmax: int) -> torch.Tensor:
    """Batched-query int8 l2max scan over one dense bucket.

    sents: int8[N, S, D]; scales, norms: f32[N, S] per-sentence dequantisation
    scale and squared norm of the stored vector (+inf at pads); q:
    f32[B, qmax, D]; q_lens: int[B].  Returns f32[N, B]: per document the max
    of 2 scale (q.x_i8) - |x|^2 - |q_j|^2 over (sentence, valid query
    sentence), the scores of index/dense.score_buckets_batched (about -1e30 at
    padded documents, by the +inf norm fold).  CUDA tensors launch the kernel,
    CPU tensors run the plain version.  More than `query_cap` query sentences
    are scored in groups (`int8_groups`) that join the batch as extra
    queries.
    """
    if q.shape[1] != qmax:
        raise ValueError(f"q is {tuple(q.shape)}, qmax {qmax}")
    rows, groups = int8_groups(qmax, sents.shape[-1])
    if groups > 1:
        qg, _ = query_groups(q, rows)
        lens = (q_lens.reshape(-1, 1) - rows * torch.arange(
            groups, device=q_lens.device)).clamp(0, rows).reshape(-1)
        return fold_groups(fused_l2max_scan_int8_batched(
            sents, scales, norms, qg, lens, rows), groups)
    if not sents.is_cuda:
        return fused_l2max_scan_int8_batched_plain(sents, scales, norms, q,
                                                   q_lens, qmax)
    if sents.dtype != torch.int8:
        raise TypeError(f"the int8 scan kernel takes int8 rows, got {sents.dtype}")
    qf = q.float()
    q_norms = (qf * qf).sum(dim=2)
    if scan_wide(q.shape[0], qmax, sents.shape[2]):
        # the wide kernel packs the real sentences and reads qadd at them alone
        out = _launch("aspire_scan_int8", sents, scales, norms, qf, -q_norms, q_lens)
        fused_l2max_scan_int8_batched.wide_launches += 1
        return out
    qadd = torch.where(_query_mask(qmax, q_lens), -q_norms,
                       torch.full_like(q_norms, NEG))
    out = _launch("aspire_scan_int8", sents, scales, norms, qf, qadd)
    fused_l2max_scan_int8_batched.launches += 1
    return out


# launches of csrc/scan.cu's int8 kernel and of csrc/scan_int8.cu's
fused_l2max_scan_int8_batched.launches = 0
fused_l2max_scan_int8_batched.wide_launches = 0
