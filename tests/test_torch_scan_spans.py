"""The scans' launch layout (K8, K7): a launch's unit of rows is a span of the
bucket's flat [n * S] rows (`span_rows`), not a number of documents, and a
query of several column groups is one launch (`launch_plan`).  The kernels'
walk of a launch is written out here (`emulate`): per span the maxima of the
documents it touches, in slots counted from the span's first document,
merged by the kernel's epilogue rule, then stored where the document lies
inside the span and merged by max into an output of -inf where it straddles
two spans.  Every maximum is exact, so on integer-valued reps (every product
and sum exact too) the walk must give the plain versions' scores bit for bit
whatever the layout; on real values it is held against the Pallas scans in
interpret mode (1e-4 on bf16 rows, 2e-4 on int8, as test_torch_scan.py).
Pad-only documents give what the kernels give: -inf on bf16 rows (the
plain version gives -1e30 where padded query columns exist), the folded
-1e30 on int8 rows.  The wrappers' CUDA route is driven on the CPU with
`_launch` recorded, to show one launch a bucket for a grouped query."""
from unittest import mock

import ml_dtypes
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.ops import pallas_scan as jscan
from aspire_tpu_torch.ops import scan_kernel as sk

# csrc/scan_int8.cu: rows a tile, rows a warp, the walk (S x pairs a query)
# from which its epilogue merges rows by warps (and wherever a span is not 64
# whole documents); csrc/scan.cu: a warp's chunk
WIDE_TILE, WIDE_WARP, LONG_WALK = 128, 16, 64
NARROW_WARP = 32


def _integers(rng, shape, top=8):
    return np.rint(rng.uniform(-top, top, shape)).astype(np.float32)


def _lengths(rng, n, s):
    lens = rng.integers(1, s + 1, n)
    lens[rng.permutation(n)[: max(1, n // 8)]] = 0       # pad-only documents
    return lens


def emulate(v: torch.Tensor, n: int, s: int, plan: sk.ScanPlan) -> torch.Tensor:
    """The kernel's per-document maxima [n, Q] from v [n * s, Q], each row's
    maximum over each query's columns plus the row's term, walked as `plan`
    lays out the launch."""
    wide = plan.kernel.endswith("_wide")
    # the wide kernel's short epilogue runs on spans of 64 whole documents
    long_walk = not wide or s * (plan.tiles_q // 2) >= LONG_WALK or plan.span != 64 * s
    warp_rows = WIDE_WARP if wide else NARROW_WARP
    tile = WIDE_TILE if wide else plan.span
    total = n * s
    out = torch.full((n, v.shape[1]), -torch.inf)
    for unit in range(plan.spans):
        row0 = unit * plan.span
        rows = min(plan.span, total - row0)
        doc0 = row0 // s
        docs = (row0 + rows - 1) // s - doc0 + 1
        assert docs <= sk.SPAN_DOCS
        docmax = torch.full((sk.SPAN_DOCS, v.shape[1]), -torch.inf)

        def merge(slot, values):
            docmax[slot] = torch.maximum(docmax[slot], values)

        for r0 in range(0, rows, tile):
            if long_walk:
                for w in range(r0, r0 + tile, warp_rows):
                    a = row0 + w
                    if w + warp_rows - 1 < rows and a // s == (a + warp_rows - 1) // s:
                        merge(a // s - doc0, v[a:a + warp_rows].amax(dim=0))
                    else:
                        for r in range(w, min(w + warp_rows, rows)):
                            merge((row0 + r) // s - doc0, v[row0 + r])
            else:
                a, e = row0 + r0, row0 + min(r0 + tile, rows)
                for d in range(a // s, (e - 1) // s + 1):
                    merge(d - doc0, v[max(d * s, a):min((d + 1) * s, e)].amax(dim=0))
        for i in range(docs):
            d = doc0 + i
            if d * s >= row0 and (d + 1) * s <= row0 + rows:
                out[d] = docmax[i]
            else:
                out[d] = torch.maximum(out[d], docmax[i])
    return out


def bf16_rows(sents, q, norms, q_n, qadd):
    """v of one query on bf16 rows: max over valid query sentences of
    2 q.x - |x|^2 + qadd (pad rows -inf: the kernel adds their -inf norm)."""
    n, s, d = sents.shape
    sims = sents.float().reshape(n * s, d) @ q.to(sents.dtype).float().t()
    valid = torch.arange(q.shape[0]) < q_n
    add = torch.where(valid, qadd, torch.full_like(qadd, sk.NEG))
    return (2.0 * sims - norms.reshape(-1, 1) + add[None]).amax(dim=1, keepdim=True)


def int8_rows(sents, scales, norms, q, q_lens, qmax):
    """v of a query batch on int8 rows, in the plain version's arithmetic."""
    n, s, d = sents.shape
    bsz = q.shape[0]
    qf = q.float()
    qadd = torch.where(torch.arange(qmax)[None] < q_lens[:, None],
                       -(qf * qf).sum(dim=2), torch.full((bsz, qmax), sk.NEG))
    sims = sents.reshape(n * s, d).float() @ qf.to(torch.bfloat16).float() \
        .reshape(bsz * qmax, d).t()
    rb = torch.where(torch.isfinite(norms), -norms, torch.full_like(norms, sk.NEG))
    scores = (2.0 * scales).reshape(-1, 1) * sims + rb.reshape(-1, 1) + qadd.reshape(1, -1)
    return scores.reshape(n * s, bsz, qmax).amax(dim=2)


def _bf16_bucket(rng, n, s, d, integer=True):
    lens = _lengths(rng, n, s)
    live = np.arange(s)[None, :] < lens[:, None]
    x = (_integers(rng, (n, s, d)) if integer
         else rng.normal(size=(n, s, d)).astype(np.float32)) * live[:, :, None]
    x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    norms = np.where(live, np.einsum("nsd,nsd->ns", x, x), np.inf).astype(np.float32)
    return (torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(norms),
            torch.from_numpy(lens > 0))


def _int8_rows(rng, n, s, d, integer=True):
    lens = _lengths(rng, n, s)
    live = np.arange(s)[None, :] < lens[:, None]
    xi = (rng.integers(-127, 128, (n, s, d)) * live[:, :, None]).astype(np.int8)
    # powers of two keep every product exact; real scales for the Pallas case
    scales = (2.0 ** rng.integers(-6, -2, (n, s)) if integer
              else rng.uniform(0.005, 0.03, (n, s))).astype(np.float32)
    scales = np.where(live, scales, 1.0).astype(np.float32)
    sq = np.einsum("nsd,nsd->ns", xi.astype(np.float32), xi.astype(np.float32))
    norms = np.where(live, sq * scales * scales, np.inf).astype(np.float32)
    return (torch.from_numpy(xi), torch.from_numpy(scales), torch.from_numpy(norms),
            torch.from_numpy(lens > 0))


def _int8_groups(q, q_lens, qmax, d):
    """The wrapper's batch: past the cap each query's groups (`int8_groups`)
    join it as extra queries (q [B G, rows, D], their lengths, G, rows)."""
    rows, groups = sk.int8_groups(qmax, d)
    if groups == 1:
        return q, q_lens, 1, qmax
    qg, _ = sk.query_groups(q, rows)
    lens = (q_lens.reshape(-1, 1) - rows * torch.arange(groups)).clamp(0, rows).reshape(-1)
    return qg, lens, groups, rows


@pytest.mark.parametrize("s", [1, 2, 3, 7, 12, 16, 17, 24, 40, 63, 300, 1200, 1500])
def test_a_span_touches_at_most_the_documents_a_block_keeps(s):
    span = sk.span_rows(s)
    # 64 whole documents (the first kernels' blocks) up to SPAN_ROWS rows
    assert span == (64 * s if s <= 24 else sk.SPAN_ROWS)
    # from every offset of its first row in a document
    for off in range(min(s, 50)):
        assert (off + span - 1) // s + 1 <= sk.SPAN_DOCS


@pytest.mark.parametrize("dtype,n,s,d,bsz,qmax,kernel,groups,blocks", [
    # a full-text bf16 query of 300 sentences: its three groups, one launch
    (torch.bfloat16, 840, 1200, 768, 3, 128, "aspire_scan_bf16_wide", 3, 132),
    # an abstract's query on the 125,000-document buckets: csrc/scan.cu
    (torch.bfloat16, 109440, 12, 768, 1, 16, "aspire_scan_bf16", 1, 1710),
    (torch.bfloat16, 840, 1200, 768, 1, 16, "aspire_scan_bf16", 1, 657),
    # past 768 wide the groups hold 64 sentences and stay on csrc/scan.cu
    (torch.bfloat16, 40, 300, 1024, 5, 64, "aspire_scan_bf16", 5, 40),
    # int8: 8 full-text queries are 40 groups of 64, two to a column group;
    # 32 abstracts are 4 column groups
    (torch.int8, 840, 1200, 768, 40, 64, "aspire_scan_int8_wide", 20, 120),
    (torch.int8, 109440, 12, 768, 32, 16, "aspire_scan_int8_wide", 4, 132),
    (torch.int8, 15568, 24, 768, 1, 16, "aspire_scan_int8", 1, 244),
    (torch.float32, 100, 12, 768, 3, 128, "aspire_scan_f32", 3, 6),
])
def test_launch_plan(dtype, n, s, d, bsz, qmax, kernel, groups, blocks):
    plan = sk.launch_plan(dtype, n, s, d, bsz, qmax, sms=132)
    assert (plan.kernel, plan.groups, plan.blocks) == (kernel, groups, blocks)
    assert plan.padded >= bsz and plan.tiles % plan.tiles_q == 0
    if dtype != torch.float32:
        assert plan.span == sk.span_rows(s) and plan.spans == -(-n * s // plan.span)
    wide = kernel.endswith("_wide")
    assert wide == (dtype != torch.float32 and sk.scan_wide(bsz, qmax, d))
    # a wide launch: persistent blocks, a group's on every SM it can have
    assert plan.blocks == (groups * min(132 // groups, plan.spans) if wide
                           else groups * plan.spans)


@pytest.mark.parametrize("n,s,d", [(60, 40, 64), (3, 1500, 64), (90, 24, 32),
                                   (120, 12, 32), (300, 1, 32), (12, 300, 64)])
@pytest.mark.parametrize("qpad,q_n", [(16, 10), (100, 100), (130, 130), (300, 290)])
def test_bf16_walk_equals_the_plain_scan(rng, n, s, d, qpad, q_n):
    sents, norms, live = _bf16_bucket(rng, n, s, d)
    q = torch.from_numpy(_integers(rng, (qpad, d)))
    qadd = -(q * q).sum(dim=1)
    cap = sk.query_cap(torch.bfloat16, d)
    groups = -(-qpad // cap)
    plan = sk.launch_plan(torch.bfloat16, n, s, d, groups, min(qpad, cap))
    assert plan.groups == groups and plan.kernel.endswith("_wide") == (qpad > 64)
    got = emulate(bf16_rows(sents, q, norms, q_n, qadd), n, s, plan)[:, 0]
    want = sk.fused_l2max_scan_plain(sents, q, norms, q_n, qadd)
    assert torch.equal(got[live], want[live])
    assert bool((got[~live] == -torch.inf).all())


@pytest.mark.parametrize("n,s,d", [(60, 40, 64), (3, 1500, 64), (90, 24, 32),
                                   (120, 12, 32), (40, 64, 32)])
@pytest.mark.parametrize("bsz,qmax", [(1, 16), (32, 16), (3, 20), (2, 300)])
def test_int8_walk_equals_the_plain_scan(rng, n, s, d, bsz, qmax):
    sents, scales, norms, live = _int8_rows(rng, n, s, d)
    q = torch.from_numpy(_integers(rng, (bsz, qmax, d)))
    q_lens = torch.from_numpy(rng.integers(1, qmax + 1, bsz))
    qg, lens, groups, width = _int8_groups(q, q_lens, qmax, d)
    plan = sk.launch_plan(torch.int8, n, s, d, bsz * groups, width)
    got = sk.fold_groups(emulate(int8_rows(sents, scales, norms, qg, lens, width), n, s, plan),
                         groups)
    want = sk.fused_l2max_scan_int8_batched_plain(sents, scales, norms, q, q_lens, qmax)
    # live and pad-only documents alike: the fold of -inf norms to -1e30
    assert torch.equal(got, want)
    assert bool((got[~live] <= 0.5 * sk.NEG).all())


def test_the_walk_takes_both_epilogues():
    """The wide kernel's short walk (abstracts: 16-sentence queries on
    documents of 12 or 24 rows) and its long one (full-text documents, or a
    query of 128 columns) are both among the cases above."""
    walk = lambda s, tiles_q: s * (tiles_q // 2) >= LONG_WALK
    assert not walk(12, 2) and not walk(24, 2) and not walk(40, 2)
    assert walk(64, 2) and walk(1500, 2) and walk(12, 16)


def test_straddling_documents_are_merged_across_spans():
    """Documents of 1,500 rows over spans of 1,536: the first lies inside
    span 0, the others in two spans each, which hold a part of their maxima
    that the output merges."""
    n, s = 3, 1500
    plan = sk.launch_plan(torch.bfloat16, n, s, 64, 1, 16)
    assert plan.span == 1536 and plan.spans == 3
    v = torch.full((n * s, 1), -5.0)
    v[100, 0] = 2.0                                 # document 0, inside span 0
    v[1510, 0], v[1540, 0] = 7.0, 3.0               # document 1, spans 0 and 1
    v[3010, 0], v[4499, 0] = 9.0, 11.0              # document 2, spans 1 and 2
    got = emulate(v, n, s, plan)[:, 0]
    assert got.tolist() == [2.0, 7.0, 11.0]


def _recorded_cuda_route(monkeypatch, calls):
    """The wrappers' CUDA route on CPU tensors: `_launch` records its query
    batch and answers with the plain version's scores of it."""
    def launch(name, sents, scales, norms, q, qadd):
        calls.append((name, tuple(q.shape)))
        out = []
        for b in range(q.shape[0]):
            valid = qadd[b] > 0.5 * sk.NEG
            out.append(sk.fused_l2max_scan_plain(sents, q[b], norms, q.shape[1],
                                                 torch.where(valid, qadd[b], sk.NEG)))
        return torch.stack(out, dim=1)
    monkeypatch.setattr(sk, "_launch", launch)
    monkeypatch.setattr(sk.fused_l2max_scan, "launches", 0)
    monkeypatch.setattr(sk.fused_l2max_scan, "wide_launches", 0)
    return mock.patch.object(torch.Tensor, "is_cuda", new_callable=mock.PropertyMock,
                             return_value=True)


@pytest.mark.parametrize("qpad,q_n,d,shape,wide", [(300, 300, 128, (3, 128, 128), 1),
                                                   (300, 299, 896, (5, 64, 896), 0),
                                                   (16, 10, 128, (1, 16, 128), 0),
                                                   (100, 100, 128, (1, 100, 128), 1)])
def test_a_grouped_query_is_one_launch_a_bucket(rng, monkeypatch, qpad, q_n, d, shape,
                                                wide):
    sents, norms, live = _bf16_bucket(rng, 20, 7, d)
    q = torch.from_numpy(_integers(rng, (qpad, d)))
    qadd = -(q * q).sum(dim=1)
    calls = []
    with _recorded_cuda_route(monkeypatch, calls):
        got = sk.fused_l2max_scan(sents, q, norms, q_n, qadd)
    assert calls == [("aspire_scan_bf16", shape)]
    assert (sk.fused_l2max_scan.wide_launches, sk.fused_l2max_scan.launches) == (wide, 1 - wide)
    want = sk.fused_l2max_scan_plain(sents, q, norms, q_n, qadd)
    assert torch.equal(got[live], want[live])


def test_bf16_walk_matches_pallas_kernel(rng):
    """Documents of 40 rows over spans of 1,536, a query of 300 sentences in
    three groups (the wide kernel's long walk)."""
    n, s, d, q_n = 64, 40, 128, 300
    sents, norms, live = _bf16_bucket(rng, n, s, d, integer=False)
    q = np.zeros((304, d), np.float32)
    q[:q_n] = rng.normal(size=(q_n, d)).astype(np.float32)
    want = np.asarray(jscan.fused_l2max_scan(
        jnp.asarray(sents.float().numpy().astype(ml_dtypes.bfloat16)), jnp.asarray(q),
        jnp.asarray(norms.numpy()), q_n=q_n, block_docs=64, interpret=True))
    qt = torch.from_numpy(q)
    plan = sk.launch_plan(torch.bfloat16, n, s, d, 3, 128)
    assert plan.kernel == "aspire_scan_bf16_wide" and plan.spans == 2
    got = emulate(bf16_rows(sents, qt, norms, q_n, torch.zeros(304)), n, s, plan)[:, 0]
    np.testing.assert_allclose(got[live].numpy(), want[live.numpy()], rtol=1e-4, atol=1e-4)
    assert bool((got[~live] == -torch.inf).all())


@pytest.mark.parametrize("bsz,qmax", [(32, 16), (2, 300)])
def test_int8_walk_matches_pallas_kernel(rng, bsz, qmax):
    n, s, d = 48, 40, 128
    sents, scales, norms, live = _int8_rows(rng, n, s, d, integer=False)
    q = rng.normal(size=(bsz, qmax, d)).astype(np.float32)
    q_lens = rng.integers(1, qmax + 1, bsz).astype(np.int32)
    want = np.asarray(jscan.fused_l2max_scan_int8_batched(
        jnp.asarray(sents.numpy()), jnp.asarray(scales.numpy()), jnp.asarray(norms.numpy()),
        jnp.asarray(q), jnp.asarray(q_lens), qmax=qmax, interpret=True))
    qg, lens, groups, width = _int8_groups(torch.from_numpy(q), torch.from_numpy(q_lens).long(),
                                           qmax, d)
    plan = sk.launch_plan(torch.int8, n, s, d, bsz * groups, width)
    assert plan.kernel == "aspire_scan_int8_wide"
    got = sk.fold_groups(emulate(int8_rows(sents, scales, norms, qg, lens, width), n, s, plan),
                         groups)
    np.testing.assert_allclose(got[live].numpy(), want[live.numpy()], rtol=2e-4, atol=2e-4)
    assert bool((got[~live] <= 0.5 * sk.NEG).all())
