"""Query-time ranking over the corpus indexes (counterpart of
aspire_tpu/index/serve.py), on one card.

  l2max first stage over the flat index: one [q_sents, dim] x [dim, L]
  product -> per-sentence best-query similarity -> segment-max over doc
  labels -> per-doc scores -> top-k (`l2max_search`).  Distances compare via
  squared L2; exposed scores take the sqrt to match the reference's -cdist.

  OT second stage: the top candidates' sentence reps go through the batched
  Sinkhorn scorer (ops.distances.wasserstein_dist) -- the reference's
  caching_scoringmodel rerank path (pp_gen_nearest.py:207-363).

  Fused query (`make_fused_query`, `make_fused_query_batched`): dense-bucket
  scan (index/dense.py: the scan kernels on CUDA tensors), candidate gather
  from the buckets on the device, OT rerank -- nothing crosses to the host in
  between.  The whole batch's candidates are gathered at once and reranked by
  ONE Sinkhorn launch in which every pair anneals from its own query's pool
  diameter (`diameter_value`), which is what a loop of per-query solves would
  compute; `rerank_chunk` bounds the gathered block for deep pools.

  Pool ranking (`make_pool_rank_batched`, `make_cls_pool_rank_batched`): score
  each query against exactly its candidate-pool ids, no retrieval stage.

Several ranks (`mesh=`, a `parallel.mesh.Mesh` with a "shard" axis; every
rank calls with the same queries): each rank scans the slices of the index it
holds, the top-k blocks merge by one all_gather (`make_sharded_search`,
`index/dense._merge_sharded_topk`), each rank gathers the candidates whose
rows it holds (`_gather_candidates(mesh=)`) and scores only those -- one
Sinkhorn launch for its share of the B * k pairs, each pair annealing from its
query's pool diameter, whose box is assembled over the ranks by a MIN and a
MAX all_reduce (`_mesh_pool_diameter`) -- and one SUM all_reduce of the
[B, k] scores, zero where a rank owns nothing, merges them.  A document lives
on one rank, so every score is its owner's, exactly.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core.types import MultiVec, require_device
from ..ops.cdist import require_fp32_matmul
from ..ops.distances import jointsm_dist, l2max_dist, wasserstein_dist
from ..ops.sinkhorn import grouped_max_diameter
from ..utils.profiling import span

NEG = -1e30
# a gathered [pairs, max_sents, dim] f32 candidate block is kept under this
GATHER_BYTES = 1 << 30


def _per_doc_scores(q_sents, q_len, sents, doc_ids, n_docs: int):
    """Per-doc l2max similarity scores for one flat sentence shard.

    q_sents: f32[sq, d]; sents: [L, d] (any float dtype); doc_ids: int[L];
    -> f32[n_docs] (-inf where a doc has no sentences in this shard).
    """
    require_fp32_matmul()
    q = q_sents.float()
    qq = torch.sum(q * q, dim=1)[:, None]
    # the products take the corpus in its storage dtype with f32
    # accumulation: bf16 operands are exact in f32, so they are written in f32
    x = sents.float()
    xx = torch.sum(x * x, dim=1)[None, :]
    qx = torch.matmul(q.to(sents.dtype).float(), x.t())
    d2 = torch.clamp_min(qq + xx - 2.0 * qx, 0.0)                 # [sq, L]
    neg = -torch.sqrt(d2)
    qmask = torch.arange(q.shape[0], device=q.device) < q_len
    neg = torch.where(qmask[:, None], neg, torch.full_like(neg, NEG))
    per_sent = neg.amax(dim=0)                                    # [L]
    per_sent = torch.where(doc_ids >= 0, per_sent,
                           torch.full_like(per_sent, NEG))
    out = torch.full((n_docs,), float("-inf"), dtype=torch.float32,
                     device=q.device)
    return out.scatter_reduce_(0, torch.clamp_min(doc_ids, 0).long(), per_sent,
                               "amax", include_self=True)


def l2max_search(q_sents, q_len, sents, doc_ids, n_docs: int, k: int):
    """Single-device search.  sents: [n_shards, L, d] or [L, d]: an index
    built for several shards is flattened and searched on one card.
    -> (top-k -L2 scores [k], doc idx [k])."""
    with torch.no_grad():
        if sents.ndim == 3:
            sents = sents.reshape(-1, sents.shape[-1])
            doc_ids = doc_ids.reshape(-1)
        scores = _per_doc_scores(q_sents, q_len, sents, doc_ids, n_docs)
        return torch.topk(scores, k)


def make_sharded_search(mesh, n_docs: int, k: int):
    """The flat index's search over a serving mesh: each rank scores its own
    shard ([L, d] or [1, L, d], `MultiVecIndex.device_arrays(mesh=)`), keeps
    its top k, and one all_gather of the ranks' k-sized blocks plus a second
    top-k merges them.  Returns fn(q_sents, q_len, sents, doc_ids) -> (top-k
    -L2 scores [k], doc idx [k]), the same on every rank.

    Documents never span shards (build_index_from_reps packs whole docs), so
    each shard's per-doc scores are complete."""
    from .dense import _merge_sharded_topk
    if k > n_docs:
        # the gathered pool would hold -inf entries naming real doc ids, so
        # the final top-k could return a doc twice -- refuse loudly
        raise ValueError(f"k={k} exceeds the index's n_docs={n_docs}")

    def search(q_sents, q_len, sents, doc_ids):
        with torch.no_grad():
            if sents.ndim == 3:
                sents, doc_ids = sents[0], doc_ids[0]
            scores = _per_doc_scores(q_sents, q_len, sents, doc_ids, n_docs)
            v, i = torch.topk(scores, k)
            v, i = _merge_sharded_topk(v[None], i[None], k, mesh)
            return v[0], i[0]

    return search


def sharded_l2max_search(index, mesh, q_sents, q_len: int, k: int = 50):
    """One sharded search from a host-side flat index (every rank passes the
    same index and query)."""
    sents, doc_ids = index.device_arrays(mesh=mesh)
    fn = make_sharded_search(mesh, index.n_docs, k)
    q = torch.as_tensor(np.asarray(q_sents, np.float32)).to(mesh.device)
    return fn(q, q_len, sents, doc_ids)


def gather_doc_reps(index, doc_idx, max_sents: int, device="cuda") -> MultiVec:
    """Host-side gather of candidate sentence reps for the rerank stage.

    index: MultiVecIndex; doc_idx: [k] global doc indices (-1 = pad slot).
    Returns a padded MultiVec [k, max_sents, dim] (f32) on `device`.
    """
    dev = require_device(device)
    flat_sents = index.sents_f32().reshape(-1, index.dim)
    flat_ids = index.doc_ids.reshape(-1)
    order = np.argsort(flat_ids, kind="stable")
    sorted_ids = flat_ids[order]
    doc_idx = np.asarray(doc_idx)
    starts = np.searchsorted(sorted_ids, doc_idx, side="left")
    k = len(doc_idx)
    out = np.zeros((k, max_sents, index.dim), np.float32)
    lens = np.zeros((k,), np.int32)
    for i, di in enumerate(doc_idx):
        if di < 0:      # pad slot (pool < k): zero rows, not index -1
            continue
        ln = min(int(index.doc_lens[di]), max_sents)
        rows = order[starts[i]: starts[i] + ln]
        out[i, :ln] = flat_sents[rows]
        lens[i] = ln
    return MultiVec(embed=torch.from_numpy(out).to(dev),
                    lens=torch.from_numpy(lens).to(dev))


def _tile_query(q: MultiVec, k: int) -> MultiVec:
    return MultiVec(embed=q.embed.expand(k, *q.embed.shape[1:]),
                    lens=q.lens.expand(k))


def ot_rerank(q: MultiVec, cands: MultiVec, blur: float = 0.05,
              scaling: float = 0.9, temp: float = 1.0, max_iters: int = 128,
              solver: str = "kernel") -> torch.Tensor:
    """Batched Sinkhorn rerank of k candidates against one query.

    q: MultiVec with batch 1; cands: MultiVec with batch k, on the same
    device.  Returns f32[k] OT similarity scores (plan-weighted similarity
    sums).  Serving needs no gradients, so the default solver is the CUDA
    kernel; pass solver='torch' for the differentiable plain solver.  For
    latency-critical serving pass scaling=0.8, max_iters=64 ("fast OT"):
    about half the iterations, scores deviate slightly from parity.
    """
    with torch.no_grad():
        sims, _ = wasserstein_dist(
            _tile_query(q, cands.batch), cands, blur=blur, scaling=scaling,
            temp=temp, return_pair_sims=True, max_iters=max_iters,
            solver=solver)
    return sims


def l2max_rerank(q: MultiVec, cands: MultiVec) -> torch.Tensor:
    """Batched single-match rerank (exact reference scores incl. sqrt)."""
    with torch.no_grad():
        sims, _ = l2max_dist(_tile_query(q, cands.batch), cands,
                             return_pair_sims=True)
    return sims


def _gather_candidates(buckets, doc_bucket, doc_row, doc_lens, cand_ids,
                       max_sents: int, mesh=None):
    """On-device candidate rep gather for the fused query and pool paths.

    buckets: device bucket dicts; doc_bucket/doc_row/doc_lens: [n_docs]
    inverse maps (DenseBucketIndex.device_pos_arrays); cand_ids: int[K] global
    doc ids (-1 = pad).  Returns (embed f32[K, max_sents, d], lens int32[K]
    (1 at pad slots), owned bool[K], valid bool[K]); a pad id gives zero rows,
    never the last document.  Under a serving mesh the buckets are this rank's
    slices: only the candidates whose rows it holds are filled (zeros
    elsewhere), and `owned` marks them; on one device owned == valid.  No step
    reads a value back on the host.
    """
    n = cand_ids.shape[0]
    with span("gather", bytes=_gather_bytes(buckets, n, max_sents)):
        valid = cand_ids >= 0
        cid = torch.clamp_min(cand_ids, 0).long()
        cb = doc_bucket[cid]
        cr = doc_row[cid].long()
        cl = torch.where(valid, torch.clamp_max(doc_lens[cid], max_sents),
                         torch.ones_like(doc_lens[cid]))
        cl = torch.clamp_min(cl, 1).to(torch.int32)
        dim = buckets[0]["sents"].shape[-1]
        out = torch.zeros((n, max_sents, dim), dtype=torch.float32,
                          device=cand_ids.device)
        owned = torch.zeros_like(valid)
        for bi, b in enumerate(buckets):
            sel = (cb == bi) & valid
            if mesh is not None:
                local_n = b["sents"].shape[0]
                sel = sel & (cr // local_n == mesh.index("shard"))
                cr_b = cr % local_n
            else:
                cr_b = cr
            rows = torch.where(sel, cr_b, torch.zeros_like(cr_b))
            s_eff = min(b["sents"].shape[1], max_sents)
            reps = b["sents"][rows, :s_eff].float()              # [K, s_eff, d]
            if "scales" in b:
                reps = reps * b["scales"][rows, :s_eff, None]
            smask = torch.arange(s_eff, device=cl.device)[None, :] < cl[:, None]
            keep = (sel[:, None] & smask)[:, :, None]
            out[:, :s_eff] += torch.where(keep, reps, torch.zeros_like(reps))
            owned |= sel
        return out, cl, owned, valid


def _gather_bytes(buckets, n: int, max_sents: int) -> int:
    """Bytes of index rows and scales that gathering n candidates indexes,
    over every bucket: n rows of each bucket's first min(width, max_sents)
    sentences (a pad or foreign slot reads row 0)."""
    total = 0
    for b in buckets:
        s_eff = min(b["sents"].shape[1], max_sents)
        per_sent = b["sents"].shape[-1] * b["sents"].element_size()
        if "scales" in b:
            per_sent += b["scales"].element_size()
        total += n * s_eff * per_sent
    return total


_BIG = 3.0e38


def _mesh_pool_diameter(q, emb, owned, valid, mesh):
    """Each query's whole-pool annealing diameter, assembled over the ranks.

    One-device semantics: the schedule starts at the diameter of the box
    spanning ALL points of the query and its k candidates, pads included
    (ops/sinkhorn.grouped_max_diameter).  A rank holds only the candidates it
    owns, so its box is partial; a MIN and a MAX all_reduce of the per-query
    boxes (2 * B * d floats) give the whole one.  q [B, qmax, d] (the same on
    every rank); emb [B, k, ms, d] this rank's gather; owned, valid [B, k].
    Pad candidates are zero rows on one device, so the box closes over 0
    where a query has one.  Returns f32[B]."""
    group = mesh.group("shard")
    sel = owned[:, :, None, None]
    y_min = torch.where(sel, emb, torch.full_like(emb, _BIG)).amin(dim=(1, 2))
    y_max = torch.where(sel, emb, torch.full_like(emb, -_BIG)).amax(dim=(1, 2))
    with span("reduce", bytes=2 * y_min.numel() * y_min.element_size()):
        dist.all_reduce(y_min, op=dist.ReduceOp.MIN, group=group)
        dist.all_reduce(y_max, op=dist.ReduceOp.MAX, group=group)
    pad0 = (~valid).any(dim=1)[:, None]                          # [B, 1]
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    big = torch.full((), _BIG, dtype=q.dtype, device=q.device)
    mins = torch.minimum(torch.minimum(q.amin(dim=1), y_min),
                         torch.where(pad0, zero, big))
    maxs = torch.maximum(torch.maximum(q.amax(dim=1), y_max),
                         torch.where(pad0, zero, -big))
    return torch.linalg.vector_norm(maxs - mins, dim=-1)


def _on_owned(score, qt: MultiVec, cands: MultiVec, owned, *per_pair):
    """score(qt, cands, *per_pair) over the pairs this rank owns only, one
    call for all of them; f32 zeros at the other pairs (owned=None: every
    pair, as on one device)."""
    if owned is None:
        return score(qt, cands, *per_pair)
    idx = torch.nonzero(owned).flatten()
    out = torch.zeros(owned.shape[0], dtype=torch.float32, device=owned.device)
    if idx.numel():
        sub = lambda mv: MultiVec(embed=mv.embed[idx], lens=mv.lens[idx])
        out[idx] = score(sub(qt), sub(cands),
                         *(x[idx] for x in per_pair)).float()
    return out


def _sum_over_shards(sims, mesh):
    """The [B, k] scores the ranks computed for the pairs they own, zero at
    the others: one SUM all_reduce gives every rank each owner's score."""
    if mesh is not None:
        sims = sims.contiguous()
        with span("reduce", bytes=sims.numel() * sims.element_size()):
            dist.all_reduce(sims, op=dist.ReduceOp.SUM,
                            group=mesh.group("shard"))
    return sims


def _tile_queries(q, q_lens, per_query: int) -> MultiVec:
    """[B, qmax, d], [B] -> a MultiVec of B * per_query pairs, each query
    repeated for its candidates."""
    bsz = q.shape[0]
    embed = q[:, None].expand(bsz, per_query, *q.shape[1:])
    return MultiVec(embed=embed.reshape(bsz * per_query, *q.shape[1:]),
                    lens=q_lens[:, None].expand(bsz, per_query).reshape(-1))


def _query_chunks(bsz: int, per_query: int, max_sents: int, dim: int,
                  chunk: int | None) -> int:
    """Queries gathered and scored at a time: `chunk`, or as many as keep the
    gathered f32 block within GATHER_BYTES."""
    if chunk is None:
        chunk = max(1, GATHER_BYTES // (per_query * max_sents * dim * 4))
    return max(1, min(bsz, chunk))


def make_fused_query_batched(n_buckets: int, k: int, max_sents: int,
                             int8: bool = False, q_chunk: int | None = None,
                             blur: float = 0.05, scaling: float = 0.9,
                             temp: float = 1.0, max_iters: int = 128,
                             solver: str = "kernel", scan: str = "kernel",
                             rerank_chunk: int | None = None, mesh=None):
    """Batched fused serving: B queries -> search + gather + rerank on the
    device.  fn(q [B, qmax, d], q_lens int[B] (a host int at B = 1),
    *bucket_arrays, doc_bucket, doc_row, doc_lens) -> (stage1 scores [B, k]
    (-L2, reference scale), doc_idx [B, k], ot_sims [B, k] (NEG at pad
    slots)).  The extra arguments come from DenseBucketIndex.device_arrays()
    + .device_pos_arrays().

    scan: 'kernel' (the CUDA scan kernels on CUDA tensors) or 'torch';
    solver: 'kernel' (the CUDA Sinkhorn solver) or 'torch'.  CPU tensors run
    the plain versions under either name.

    The rerank's annealing diameter must cover exactly one query's candidate
    pool (the reference makes one geomloss call a query).  Here all B * k
    pairs go to one solve and each pair is given its own query's pool
    diameter, so no query is coupled to another.  rerank_chunk: queries
    gathered and reranked at a time (default: as many as keep the gathered
    f32 block under 1 GiB); q_chunk: see score_buckets_batched.

    mesh: the bucket arrays are this rank's slices (device_arrays(mesh=)),
    the position arrays whole; the scans' top-k blocks merge over the ranks,
    each rank reranks only the candidates it owns (one solver call for them,
    each pair with its query's pool diameter from `_mesh_pool_diameter`) and
    one SUM all_reduce of the [B, k] scores merges the reranks."""
    from .dense import (_merge_sharded_topk, _unflatten_buckets,
                        score_buckets_batched)

    def ot(qt, cands, diam):
        s, _ = wasserstein_dist(
            qt, cands, blur=blur, scaling=scaling, temp=temp,
            return_pair_sims=True, max_iters=max_iters, solver=solver,
            diameter_value=diam)
        return s

    def fused(q, q_lens, *rest):
        with torch.no_grad(), span("fused_query", queries=q.shape[0]):
            flat, (db, dr, dl) = rest[:-3], rest[-3:]
            buckets = _unflatten_buckets(flat, n_buckets, int8)
            q_lens = torch.as_tensor(q_lens, device=q.device).reshape(-1)
            q = q.float()
            v, d = score_buckets_batched(buckets, q, q_lens, k, q_chunk,
                                         scan=scan)
            if mesh is not None:
                v, d = _merge_sharded_topk(v, d, k, mesh)
            bsz = q.shape[0]
            step = _query_chunks(bsz, k, max_sents, q.shape[-1], rerank_chunk)
            sims = []
            for i in range(0, bsz, step):
                qc, qlc, dc = q[i:i + step], q_lens[i:i + step], d[i:i + step]
                nq = qc.shape[0]
                emb, cl, owned, valid = _gather_candidates(
                    buckets, db, dr, dl, dc.reshape(-1), max_sents, mesh)
                with span("rerank", pairs=nq * k):
                    qt = _tile_queries(qc, qlc, k)
                    if mesh is None:
                        with span("diameter"):
                            diam = grouped_max_diameter(qt.embed, emb, nq)
                        s = ot(qt, MultiVec(embed=emb, lens=cl), diam)
                    else:
                        with span("diameter"):
                            diam = _mesh_pool_diameter(
                                qc, emb.reshape(nq, k, *emb.shape[1:]),
                                owned.reshape(nq, k), valid.reshape(nq, k),
                                mesh)
                        s = _on_owned(ot, qt, MultiVec(embed=emb, lens=cl),
                                      owned, diam.repeat_interleave(k))
                    sims.append(s.reshape(nq, k))
            with span("scores"):
                sims = _sum_over_shards(torch.cat(sims), mesh)
                sims = torch.where(d >= 0, sims, torch.full_like(sims, NEG))
                return -torch.sqrt(torch.clamp_min(-v, 0.0)), d, sims

    return fused


def make_fused_query(n_buckets: int, k: int, max_sents: int,
                     int8: bool = False, blur: float = 0.05,
                     scaling: float = 0.9, temp: float = 1.0,
                     max_iters: int = 128, solver: str = "kernel",
                     scan: str = "kernel", mesh=None):
    """Serving query on the device: search + candidate gather + OT rerank.

    The reference's query path is three host-mediated stages (NN scan, dict
    fetch of candidate reps, OT rescore -- pp_gen_nearest.py:207-363,
    729-985).  Here nothing touches the host in between.

    Returns fn(q [qmax, d], q_len, *bucket_arrays, doc_bucket, doc_row,
    doc_lens) -> (stage1 scores f32[k], doc_idx [k], ot_sims f32[k] (NEG at
    pad slots)).  This IS the batched path at B=1 (mesh: see there).
    """
    batched = make_fused_query_batched(
        n_buckets, k, max_sents, int8=int8, blur=blur, scaling=scaling,
        temp=temp, max_iters=max_iters, solver=solver, scan=scan, mesh=mesh)

    def single(q, q_len, *rest):
        v, d, s = batched(q[None], q_len, *rest)
        return v[0], d[0], s[0]

    return single


def make_pool_rank_batched(n_buckets: int, pool_size: int, max_sents: int,
                           agg: str = "ot", int8: bool = False,
                           blur: float = 0.05, scaling: float = 0.9,
                           temp: float = 1.0, max_iters: int = 128,
                           solver: str = "kernel", score_type: str = "l2",
                           rerank_chunk: int | None = None, mesh=None):
    """POOL-restricted ranking: score each query against exactly its
    candidate-pool ids, all pool members, no retrieval stage.

    The reference's primary evaluation protocol is pool RE-RANKING
    (`caching_scoringmodel_rank_pool_sent`, pp_gen_nearest.py:241-283).
    Candidate reps are gathered ON DEVICE from the dense buckets by doc id
    and scored with the model's own aggregation.

    fn(q [B, qmax, d], q_lens int[B], cand_ids int[B, P] (-1 = pad),
       *bucket_arrays, doc_bucket, doc_row, doc_lens) -> sims f32[B, P]
    (NEG at pad slots).

    agg: 'ot' (otAspire Sinkhorn; diameter='pair', so a pair's score does not
    depend on what it is batched with), 'l2max' (tsAspire single match),
    'cosine_max' (sent-family indexes -- reps stored unit-normalised, scores
    returned as cosine = 1 - L2^2/2) or 'jointsm'.  solver: the OT solver,
    'kernel' or 'torch'.  rerank_chunk: queries scored at a time.
    mesh: each rank gathers and scores only the pool members whose rows it
    holds (the per-pair diameter is exact on the owner), one SUM all_reduce
    of the [B, P] scores merges them.
    """
    from .dense import _unflatten_buckets

    if agg not in ("ot", "l2max", "cosine_max", "jointsm"):
        raise ValueError(f"unknown pool agg {agg}")
    if agg == "cosine_max" and score_type != "cosine":
        raise ValueError("cosine_max pool scoring expects a sent-family "
                         "index (unit-normalized reps)")

    def score(qt, cm):
        if agg == "ot":
            s, _ = wasserstein_dist(
                qt, cm, blur=blur, scaling=scaling, temp=temp,
                return_pair_sims=True, max_iters=max_iters, solver=solver,
                diameter="pair")
        elif agg == "jointsm":
            neg, _ = jointsm_dist(qt, cm, return_pair_sims=True)
            s = -neg   # poly-encoder returns the negated summed score
        else:
            s, _ = l2max_dist(qt, cm, return_pair_sims=True)
            if agg == "cosine_max":
                # unit vectors: cos = 1 - L2^2/2
                s = 1.0 - s * s / 2.0
        return s

    def rank(q, q_lens, cand_ids, *rest):
        if cand_ids.shape[1] != pool_size:
            raise ValueError(f"cand_ids is {tuple(cand_ids.shape)}, built "
                             f"for pools of {pool_size}")
        with torch.no_grad(), span("pool_rank", queries=q.shape[0]):
            flat, (db, dr, dl) = rest[:-3], rest[-3:]
            buckets = _unflatten_buckets(flat, n_buckets, int8)
            q = q.float()
            bsz = q.shape[0]
            step = _query_chunks(bsz, pool_size, max_sents, q.shape[-1],
                                 rerank_chunk)
            sims = []
            for i in range(0, bsz, step):
                qc, qlc = q[i:i + step], q_lens[i:i + step]
                emb, cl, owned, _ = _gather_candidates(
                    buckets, db, dr, dl, cand_ids[i:i + step].reshape(-1),
                    max_sents, mesh)
                with span("rerank", pairs=qc.shape[0] * pool_size):
                    qt = _tile_queries(qc, qlc, pool_size)
                    s = _on_owned(score, qt, MultiVec(embed=emb, lens=cl),
                                  None if mesh is None else owned)
                    sims.append(s.reshape(qc.shape[0], pool_size))
            with span("scores"):
                sims = _sum_over_shards(torch.cat(sims), mesh)
                return torch.where(cand_ids >= 0, sims,
                                   torch.full_like(sims, NEG))

    return rank


def make_cls_pool_rank_batched(mesh=None):
    """Pool-restricted CLS ranking: -L2 of each query's CLS vector against
    exactly its candidate pool (reference rank_pool, pp_gen_nearest.py:
    638-726, which runs sklearn NN per pool).

    fn(q [B, d], cand_ids int[B, P] (-1 = pad), reps [n_pad, d], norms
    [n_pad]) -> sims f32[B, P] = -||q - c|| (NEG at pads), in true float32 --
    this IS the final ranking.  mesh: reps and norms are this rank's rows
    (ClsIndex.device_arrays(mesh=)); each rank scores the candidates it
    holds and one SUM all_reduce of the [B, P] scores merges them.
    """
    def rank(q, cand_ids, reps, norms):
        require_fp32_matmul()
        with torch.no_grad():
            valid = cand_ids >= 0
            pad = ~valid
            if mesh is not None:
                local_n = reps.shape[0]
                valid = valid & (cand_ids // local_n == mesh.index("shard"))
                cand_ids = cand_ids % local_n
            rows = torch.where(valid, cand_ids,
                               torch.zeros_like(cand_ids)).long()
            c = reps[rows].float()                          # [B, P, d]
            cn = norms[rows]
            qf = q.float()
            qc = torch.einsum("bd,bpd->bp", q.to(reps.dtype).float(), c)
            d2 = torch.clamp_min(
                cn + torch.sum(qf * qf, dim=1)[:, None] - 2.0 * qc, 0.0)
            s = -torch.sqrt(d2)
            if mesh is None:
                return torch.where(valid, s, torch.full_like(s, NEG))
            s = _sum_over_shards(torch.where(valid, s, torch.zeros_like(s)),
                                 mesh)
            return torch.where(pad, torch.full_like(s, NEG), s)

    return rank
