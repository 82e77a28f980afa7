"""Dense-bucketed multi-vector index: the serving layout (counterpart of
aspire_tpu/index/dense.py).

  * documents are grouped into SENTENCE-COUNT BUCKETS (max sents 4/8/12/...);
    each bucket is a dense [n_docs_b, s_b, dim] block (bf16 by default);
  * per-sentence squared norms are precomputed ([n_docs_b, s_b] f32, +inf at
    pad slots so pads never win a max);
  * l2max scoring per bucket is one scan (2 q.x - |x|^2 - |q_j|^2, max over
    sentence and query-sentence axes) + per-bucket top-k; bucket results
    merge by a concat + global top-k;
  * optional INT8 storage (dtype="int8"): sentence vectors quantised with a
    per-sentence symmetric scale (x ~= scale * x_i8), halving scan bytes vs
    bf16.  The product upcasts int8 -> bf16 (exact; no int8 accumulation) and
    applies the scale to the sims: 2*scale*(q.x_i8) - |x|^2 - |q|^2 with norms
    precomputed on the DEQUANTISED stored values, so ordering is exact for
    what is in memory.

Where the scan runs (`scan=` of score_buckets / score_buckets_batched):

  * "kernel" (the default) on CUDA tensors: a bf16 or float32 bucket under
    one query goes through ops/scan_kernel.fused_l2max_scan, one launch a
    bucket, with ``qadd = -|q_j|^2`` so that the kernel's max is the
    scorer's (float32 rows: the kernel's true-float32 product, never TF32);
    an int8 bucket goes through fused_l2max_scan_int8_batched, one launch a
    bucket (B = 1 for a single query).  A *batch* of two or more queries over
    a bf16 or float32 bucket has no kernel (the TPU package has none either)
    and runs the chunked `torch.einsum` below; a batch of one is a single
    query and takes the scan kernel, so the fused query at B = 1 does.
    `exact` changes nothing here, because no product of this module rounds
    its operands.
  * "torch": the plain product everywhere.  CPU tensors take it under either
    name, through the wrappers' plain versions.

Doc padding (doc_idx < 0 -> NEG), top-k, the bucket merge and the final
-sqrt(max(-v, 0)) are plain tensor code outside the kernels.

Several ranks (a `parallel.mesh.Mesh` with a "shard" axis): each rank holds a
contiguous slice of every bucket's doc axis (`device_arrays(mesh=)`), scans it
with the same kernels, and the per-rank top-k blocks merge by one all_gather
of [B, k] scores and ids and a second top-k (`_merge_sharded_topk`).  The
doc -> (bucket, row) maps stay whole on every rank.  An index built with
n_shards = S pads each bucket to a multiple of 8 S rows, so S ranks split it.

Squared-L2 ordering == L2 ordering; exposed scores are sqrt'd to match the
reference's -cdist values (pp_gen_nearest.py:729-985).  The files are the JAX
package's (bucket{i}_*.npy, doc_lens.npy, meta.json, pids): an index saved by
either package loads in the other.  bfloat16 lives on the host as uint16 bits.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import torch

from ..core.types import MultiVec, require_device
from ..ops.cdist import require_fp32_matmul
from ..parallel.mesh import local_slice
from ..ops.scan_kernel import (fused_l2max_scan,
                               fused_l2max_scan_int8_batched)
from ..utils.profiling import span
from .build import (BF16, bf16_bits_to_f32, f32_to_bf16_bits,
                    host_rows_to_device, is_bf16, load_pids, save_pids)

NEG = -1e30

DEFAULT_BUCKETS = (4, 8, 12, 16, 20, 24)


@dataclasses.dataclass
class DenseBucketIndex:
    """Host-side dense-bucketed index."""

    buckets: list[dict]     # each: {"sents": [n,s,d] (uint16 bits when bf16),
                            #        "norms": [n,s] f32, "doc_idx": [n] i32,
                            #        optional "scales": [n,s] f32 (int8 mode)}
    doc_lens: np.ndarray    # [n_docs] i32 (true sentence counts)
    pids: list
    # 'l2' (aspire multi-vector reps) or 'cosine' (sent-bert family: reps
    # stored L2-NORMALIZED, so the same l2max search ranks identically to
    # cosine max-sim and rank-time scores convert via cos = 1 - L2^2/2)
    score_type: str = "l2"
    sent_dtype: str = BF16  # "bfloat16", "float32" or "int8"
    # inverse map doc -> (bucket, row), built once at build/load time so the
    # rerank candidate fetch is O(k) instead of O(n_docs) per query
    _doc_bucket: np.ndarray | None = None   # [n_docs] i32
    _doc_row: np.ndarray | None = None      # [n_docs] i32

    def _ensure_doc_pos(self) -> None:
        """Build the doc->(bucket, row) inverse map (vectorized, once)."""
        if self._doc_bucket is not None:
            return
        db = np.full((self.n_docs,), -1, np.int32)
        dr = np.zeros((self.n_docs,), np.int32)
        for bi, b in enumerate(self.buckets):
            di = b["doc_idx"]
            valid = di >= 0
            db[di[valid]] = bi
            dr[di[valid]] = np.nonzero(valid)[0].astype(np.int32)
        self._doc_bucket, self._doc_row = db, dr

    @property
    def is_int8(self) -> bool:
        return "scales" in self.buckets[0]

    @property
    def n_docs(self) -> int:
        return len(self.pids)

    @property
    def dim(self) -> int:
        return self.buckets[0]["sents"].shape[-1]

    def save(self, path) -> None:
        path = pathlib.Path(path)
        path.mkdir(parents=True, exist_ok=True)
        for i, b in enumerate(self.buckets):
            np.save(path / f"bucket{i}_sents.npy", b["sents"])
            np.save(path / f"bucket{i}_norms.npy", b["norms"])
            np.save(path / f"bucket{i}_docidx.npy", b["doc_idx"])
            if "scales" in b:
                np.save(path / f"bucket{i}_scales.npy", b["scales"])
        np.save(path / "doc_lens.npy", self.doc_lens)
        save_pids(path, self.pids)
        with open(path / "meta.json", "w") as f:
            json.dump({"n_buckets": len(self.buckets),
                       "sent_dtype": self.sent_dtype,
                       "score_type": self.score_type}, f)

    @classmethod
    def load(cls, path, mmap: bool = False) -> "DenseBucketIndex":
        """mmap: map the bucket files instead of reading them, so that a
        shard rank reads only its slice (`device_arrays(mesh=)`)."""
        path = pathlib.Path(path)
        with open(path / "meta.json") as f:
            meta = json.load(f)
        mode = "r" if mmap else None
        buckets = []
        for i in range(meta["n_buckets"]):
            b = {
                "sents": np.load(path / f"bucket{i}_sents.npy", mmap_mode=mode),
                "norms": np.load(path / f"bucket{i}_norms.npy", mmap_mode=mode),
                "doc_idx": np.load(path / f"bucket{i}_docidx.npy"),
            }
            scales_path = path / f"bucket{i}_scales.npy"
            if scales_path.exists():
                b["scales"] = np.load(scales_path, mmap_mode=mode)
            buckets.append(b)
        idx = cls(buckets=buckets, doc_lens=np.load(path / "doc_lens.npy"),
                  pids=load_pids(path), score_type=meta.get("score_type", "l2"),
                  sent_dtype=meta.get("sent_dtype", "float32"))
        idx._ensure_doc_pos()
        return idx

    def device_arrays(self, device="cuda", mesh=None) -> list[dict]:
        """The bucket arrays as tensors on one device, or under a serving
        mesh this rank's contiguous slice of every bucket's doc axis on the
        rank's device."""
        dev = require_device(device) if mesh is None else mesh.device
        bf16 = self.sent_dtype == BF16
        out = []
        for b in self.buckets:
            rows = (slice(None) if mesh is None
                    else local_slice(len(b["doc_idx"]), mesh, "shard"))
            d = {"sents": host_rows_to_device(b["sents"][rows], bf16, dev),
                 "norms": host_rows_to_device(b["norms"][rows], False, dev),
                 "doc_idx": host_rows_to_device(b["doc_idx"][rows], False, dev)}
            if "scales" in b:
                d["scales"] = host_rows_to_device(b["scales"][rows], False, dev)
            out.append(d)
        return out

    def device_pos_arrays(self, device="cuda", mesh=None) -> tuple:
        """Device copies of the doc->(bucket, row) inverse map + doc lens,
        whole on every rank of a serving mesh (the buckets are the sharded
        part).

        Feeds the FUSED query path (index.serve.make_fused_query): candidate
        gathering happens on device, so serving pays no host round trip
        between search and rerank."""
        dev = require_device(device) if mesh is None else mesh.device
        self._ensure_doc_pos()
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in (self._doc_bucket, self._doc_row,
                               np.asarray(self.doc_lens, np.int32)))

    def _rows_f32(self, b: dict, rows: np.ndarray, s: int) -> np.ndarray:
        reps = b["sents"][rows, :s]
        if self.sent_dtype == BF16:
            return bf16_bits_to_f32(reps)
        return reps.astype(np.float32)

    def gather_doc_reps(self, doc_idx, max_sents: int,
                        device="cuda") -> MultiVec:
        """Host-side gather of per-doc sentence reps for the rerank stage.

        O(k) per call via the precomputed doc->(bucket, row) inverse map --
        one fancy-indexed slice per bucket that holds candidates (the
        reference's equivalent fetch is a dict lookup over its flat rep
        matrix, pp_gen_nearest.py:207-363).
        """
        dev = require_device(device)
        self._ensure_doc_pos()
        doc_idx = np.asarray(doc_idx, np.int64)
        k = len(doc_idx)
        # pad ids (-1, from _topk_padded when the pool < k) must yield zero
        # rows, NOT numpy's negative-index wraparound to the last real doc
        valid = doc_idx >= 0
        safe = np.where(valid, doc_idx, 0)
        out = np.zeros((k, max_sents, self.dim), np.float32)
        lens = np.where(valid, np.minimum(self.doc_lens[safe], max_sents),
                        0).astype(np.int32)
        cand_bucket = np.where(valid, self._doc_bucket[safe], -1)
        cand_row = self._doc_row[safe]
        for bi in np.unique(cand_bucket[valid]):
            b = self.buckets[bi]
            sel = np.nonzero(cand_bucket == bi)[0]
            s = min(b["sents"].shape[1], max_sents)
            reps = self._rows_f32(b, cand_row[sel], s)
            if "scales" in b:  # dequantize int8 storage
                reps = reps * b["scales"][cand_row[sel], :s, None]
            # zero out pad slots past each doc's true length
            mask = (np.arange(s)[None, :] < lens[sel, None])
            out[sel, :s] = reps * mask[:, :, None]
        return MultiVec(embed=torch.from_numpy(out).to(dev),
                        lens=torch.from_numpy(lens).to(dev))


def _assign_buckets(doc_lens: np.ndarray, buckets: tuple) -> dict:
    """doc index lists per bucket size (smallest bucket that fits)."""
    by_bucket: dict[int, list[int]] = {s: [] for s in buckets}
    for di, ln in enumerate(doc_lens):
        for s in buckets:
            if ln <= s:
                by_bucket[s].append(di)
                break
    return by_bucket


def _bucket_positions(lens_b: np.ndarray):
    """(row, position) of every sentence of a bucket's docs laid end to end."""
    row_of = np.repeat(np.arange(len(lens_b)), lens_b)
    pos_of = np.arange(lens_b.sum()) - np.repeat(
        np.cumsum(lens_b) - lens_b, lens_b)
    return row_of, pos_of


def _storage(dtype) -> str:
    if dtype is None or is_bf16(dtype):
        return BF16
    if isinstance(dtype, str):
        name = dtype
    elif isinstance(dtype, torch.dtype):
        name = str(dtype).split(".")[-1]
    else:
        name = str(np.dtype(dtype))
    if name not in ("float32", "int8"):
        raise ValueError(f"storage must be bfloat16, float32 or int8, got {dtype!r}")
    return name


def build_dense_index(doc_reps: list[np.ndarray], pids: list,
                      buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                      n_shards: int = 1, dtype=None,
                      score_type: str = "l2") -> DenseBucketIndex:
    """Pack per-doc [num_sents, dim] matrices into dense buckets.

    Docs longer than the largest bucket are truncated to it.  Each bucket's
    doc count is padded to a multiple of 8*n_shards with dummy docs (doc_idx
    -1, norms +inf).

    dtype: "bfloat16" (default; also torch.bfloat16), "float32", or "int8"
    for per-sentence-scale symmetric quantisation (halves scan bytes; see
    module docstring).  Names, numpy dtypes and torch dtypes are accepted."""
    storage = _storage(dtype)
    int8 = storage == "int8"
    dim = doc_reps[0].shape[1]
    doc_lens = np.asarray([min(len(r), buckets[-1]) for r in doc_reps], np.int32)
    by_bucket = _assign_buckets(doc_lens, buckets)
    out_buckets = []
    align = 8 * n_shards
    store = {BF16: np.uint16, "float32": np.float32, "int8": np.int8}[storage]
    for s in buckets:
        idxs = by_bucket[s]
        if not idxs:
            continue
        n = -(-len(idxs) // align) * align
        sents = np.zeros((n, s, dim), store)
        norms = np.full((n, s), np.float32(np.inf), np.float32)
        doc_idx = np.full((n,), -1, np.int32)
        scales = np.zeros((n, s), np.float32) if int8 else None
        # vectorized packing: one flat [sum(lens), dim] block per bucket --
        # per-doc python work is a slice + concat only
        lens_b = np.minimum(doc_lens[idxs], s).astype(np.int64)
        flat_rows = np.concatenate(
            [np.asarray(doc_reps[di][:s], np.float32) for di in idxs], axis=0)
        row_of, pos_of = _bucket_positions(lens_b)
        # norms computed on the STORED (rounded/quantized) values so
        # 2*q.x - |x|^2 is exact for the stored vectors
        if int8:
            sc = np.abs(flat_rows).max(axis=1)
            sc /= 127.0                                       # per sentence
            sc = np.where(sc > 0, sc, 1.0).astype(np.float32)
            flat_rows /= sc[:, None]
            np.rint(flat_rows, out=flat_rows)
            np.clip(flat_rows, -127, 127, out=flat_rows)
            sents[row_of, pos_of] = flat_rows.astype(np.int8)
            scales[row_of, pos_of] = sc
            # |stored|^2 = sc^2 * sum(xi^2), no dequantized materialization
            norms[row_of, pos_of] = np.einsum(
                "ld,ld->l", flat_rows, flat_rows,
                dtype=np.float32) * (sc * sc)
        elif storage == BF16:
            bits = f32_to_bf16_bits(flat_rows)
            sents[row_of, pos_of] = bits
            stored = bf16_bits_to_f32(bits)
            norms[row_of, pos_of] = np.einsum("ld,ld->l", stored, stored)
        else:
            sents[row_of, pos_of] = flat_rows
            norms[row_of, pos_of] = np.einsum("ld,ld->l", flat_rows, flat_rows)
        doc_idx[: len(idxs)] = idxs
        b = {"sents": sents, "norms": norms, "doc_idx": doc_idx}
        if int8:
            b["scales"] = scales
        out_buckets.append(b)
    idx = DenseBucketIndex(buckets=out_buckets, doc_lens=doc_lens,
                           pids=list(pids), score_type=score_type,
                           sent_dtype=storage)
    idx._ensure_doc_pos()
    return idx


def quantize_sentences(embed: torch.Tensor):
    """Per-sentence symmetric int8 quantisation on the device the tensor lies
    on: scale = max|x| / 127 (1.0 for an all-zero row), x_i8 =
    clip(round_half_even(x / scale), -127, 127), both in float32 with an IEEE
    division -- the numbers `build_dense_index(dtype="int8")` makes on the
    host, bit for bit.

    embed: f32[..., d] -> (int8[..., d], f32[...] scales).  Feeds
    `build_dense_index_prequantized`.
    """
    x = embed.float()
    # tensor / tensor: a division by a Python number is a multiplication by
    # its reciprocal on a CUDA tensor, which rounds otherwise
    top = x.abs().amax(dim=-1)
    sc = top / torch.full_like(top, 127.0)
    sc = torch.where(sc > 0, sc, torch.ones_like(sc))
    xi = torch.clamp(torch.round(x / sc[..., None]), -127, 127)
    return xi.to(torch.int8), sc


def build_dense_index_prequantized(doc_quant: list, pids: list,
                                   buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                                   n_shards: int = 1) -> DenseBucketIndex:
    """Pack device-quantised int8 docs into a dense-bucket index.

    doc_quant: list of (xi int8 [len, d], scales f32 [len]) pairs, as
    `quantize_sentences` (or `encode_corpus(..., quantize=True)`) gives them.
    Equivalent to build_dense_index(doc_reps, dtype='int8') applied to the
    same quantised values, but the host does PACKING ONLY: the quantisation
    ran on the device and the norms come from an int32 squared-sum of the
    stored ints (|stored|^2 = sc^2 * sum(xi^2); max 768*127^2 < 2^31).
    """
    dim = doc_quant[0][0].shape[1]
    doc_lens = np.asarray([min(len(x), buckets[-1]) for x, _ in doc_quant],
                          np.int32)
    by_bucket = _assign_buckets(doc_lens, buckets)
    out_buckets = []
    align = 8 * n_shards
    for s in buckets:
        idxs = by_bucket[s]
        if not idxs:
            continue
        n = -(-len(idxs) // align) * align
        sents = np.zeros((n, s, dim), np.int8)
        norms = np.full((n, s), np.float32(np.inf), np.float32)
        doc_idx = np.full((n,), -1, np.int32)
        scales = np.zeros((n, s), np.float32)
        lens_b = np.minimum(doc_lens[idxs], s).astype(np.int64)
        flat_xi = np.concatenate(
            [np.asarray(doc_quant[di][0][:s], np.int8) for di in idxs], axis=0)
        flat_sc = np.concatenate(
            [np.asarray(doc_quant[di][1][:s], np.float32) for di in idxs])
        row_of, pos_of = _bucket_positions(lens_b)
        sents[row_of, pos_of] = flat_xi
        scales[row_of, pos_of] = flat_sc
        sq = np.einsum("ld,ld->l", flat_xi, flat_xi, dtype=np.int32)
        norms[row_of, pos_of] = sq.astype(np.float32) * flat_sc * flat_sc
        doc_idx[: len(idxs)] = idxs
        out_buckets.append({"sents": sents, "norms": norms,
                            "doc_idx": doc_idx, "scales": scales})
    idx = DenseBucketIndex(buckets=out_buckets, doc_lens=doc_lens,
                           pids=list(pids), sent_dtype="int8")
    idx._ensure_doc_pos()
    return idx


# ------------------------------------------------------------------- scoring
def _check_scan(scan: str) -> None:
    if scan not in ("kernel", "torch"):
        raise ValueError(f"scan must be 'kernel' or 'torch', got {scan!r}")


def _bucket_sims(q, bucket, exact: bool = False):
    """[n, s, q] similarity tensor q.x for one bucket, plain product.

    float storage: q is cast to the bucket dtype, f32 accumulation (bf16
    operands are exact in f32, so the product is written in f32).
    int8 storage: rows upcast int8 -> bf16 (exact), q rounded to bf16, and
    the per-sentence dequantisation scale applied to the sims.
    exact: kept for the counterpart's signature -- float32 products are true
    float32 here whatever it says (never TF32), and bf16/int8 operands are
    exact in float32."""
    require_fp32_matmul()
    sents = bucket["sents"]
    if "scales" in bucket:
        sims = torch.einsum("qd,nsd->nsq", q.to(torch.bfloat16).float(),
                            sents.float())
        return sims * bucket["scales"][:, :, None]
    return torch.einsum("qd,nsd->nsq", q.to(sents.dtype).float(), sents.float())


def _mask_and_topk(score, doc_idx, k: int):
    """score [..., n], doc_idx [n] -> pad docs at NEG, top-k, global ids."""
    score = torch.where(doc_idx >= 0, score, torch.full_like(score, NEG))
    kk = min(k, score.shape[-1])
    v, i = torch.topk(score, kk, dim=-1)
    return v, doc_idx[i]


def _kernel_route(bucket, scan: str) -> bool:
    sents = bucket["sents"]
    return scan == "kernel" and sents.is_cuda \
        and sents.dtype in (torch.bfloat16, torch.float32, torch.int8)


def _bucket_topk(q, q_norms, q_len, bucket, k: int, exact: bool = False,
                 scan: str = "kernel"):
    """One bucket: -> (top-k sq-l2max scores [k], global doc idx [k]).

    score(doc) = max over (sent, query-sent) of (2 q.x - |x|^2 - |q|^2)
    which orders identically to -L2 and equals its square up to sign."""
    norms, doc_idx = bucket["norms"], bucket["doc_idx"]
    if _kernel_route(bucket, scan):
        if "scales" in bucket:
            q_lens = torch.as_tensor(q_len, device=q.device).reshape(1)
            score = fused_l2max_scan_int8_batched(
                bucket["sents"], bucket["scales"], norms, q[None], q_lens,
                q.shape[0])[:, 0]
        else:
            score = fused_l2max_scan(bucket["sents"], q, norms, q_len,
                                     qadd=-q_norms)
        return _mask_and_topk(score, doc_idx, k)
    sims = _bucket_sims(q, bucket, exact)
    qmask = torch.arange(q.shape[0], device=q.device) < q_len
    scores3 = 2.0 * sims - norms[:, :, None] - q_norms[None, None, :]
    scores3 = torch.where(qmask[None, None, :], scores3,
                          torch.full_like(scores3, NEG))
    return _mask_and_topk(scores3.amax(dim=(1, 2)), doc_idx, k)


def _merge_sharded_topk(v, d, k: int, mesh, axis: str = "shard"):
    """Merge the ranks' top-k blocks: v, d [B, k] on each rank -> the same
    [B, k] on every rank.  One all_gather of the k-sized blocks over `axis`,
    then a top-k of the n_shards * k pool a query (the ranks' blocks side by
    side in rank order, as the JAX package's merge lays them)."""
    import torch.distributed as dist
    with span("merge"):
        group, n = mesh.group(axis), mesh.size(axis)
        v, d = v.contiguous(), d.contiguous()
        vs = [torch.empty_like(v) for _ in range(n)]
        ds = [torch.empty_like(d) for _ in range(n)]
        dist.all_gather(vs, v, group=group)
        dist.all_gather(ds, d, group=group)
        vk, pos = torch.topk(torch.cat(vs, dim=-1), k, dim=-1)
        return vk, torch.gather(torch.cat(ds, dim=-1), -1, pos)


def _topk_padded(v, d, k: int):
    """top_k over the last axis, padding the candidate pool with NEG/-1 when
    it holds fewer than k entries (tiny shards/buckets)."""
    m = v.shape[-1]
    if m < k:
        v = torch.nn.functional.pad(v, (0, k - m), value=NEG)
        d = torch.nn.functional.pad(d, (0, k - m), value=-1)
    vk, ik = torch.topk(v, k, dim=-1)
    return vk, torch.gather(d, -1, ik)


def _unflatten_buckets(flat, n_buckets: int, int8: bool) -> list[dict]:
    per = 4 if int8 else 3
    keys = ("sents", "norms", "doc_idx", "scales")[:per]
    return [dict(zip(keys, flat[per * i: per * (i + 1)]))
            for i in range(n_buckets)]


def score_buckets(buckets: list[dict], q, q_len, k: int,
                  exact: bool = False, scan: str = "kernel"):
    """Top-k l2max doc scores over a list of (device) bucket dicts.

    q: f32[qmax, d]; -> (sq-l2max scores [k], global doc idx [k]).
    exact: true-float32 scan for indexes whose scan is the final ranking.
    scan: "kernel" (CUDA tensors: bf16 and float32 buckets through the scan
    kernel of their dtype, int8 buckets through the int8 one at B = 1; CPU
    tensors through the plain product) or "torch" (the plain product)."""
    _check_scan(scan)
    with torch.no_grad():
        q = q.float()
        q_norms = torch.sum(q * q, dim=1)
        vs, ds = [], []
        for b in buckets:
            v, d = _bucket_topk(q, q_norms, q_len, b, k, exact, scan)
            vs.append(v)
            ds.append(d)
        return _topk_padded(torch.cat(vs), torch.cat(ds), k)


def _finish(v, d):
    return -torch.sqrt(torch.clamp_min(-v, 0.0)), d


def make_dense_search(n_buckets: int, k: int, int8: bool = False,
                      exact: bool = False, scan: str = "kernel", mesh=None):
    """Build the search fn over device bucket arrays.

    Returns fn(q [qmax, d], q_len, *bucket_arrays) -> (scores [k], doc_idx [k])
    with scores = -sqrt(max(-sq_score, 0)) matching reference -L2 values.
    int8=True for an index built with dtype="int8" (4 arrays per bucket).
    exact=True for indexes whose scan IS the final ranking (score_type
    "cosine").  scan: see `score_buckets`.  mesh: the bucket arrays are this
    rank's slices (`device_arrays(mesh=)`); every rank calls fn with the same
    query and gets the same merged top-k.
    """
    def search(q, q_len, *flat):
        buckets = _unflatten_buckets(flat, n_buckets, int8)
        v, d = score_buckets(buckets, q, q_len, k, exact, scan)
        if mesh is not None:
            v, d = _merge_sharded_topk(v[None], d[None], k, mesh)
            v, d = v[0], d[0]
        return _finish(v, d)
    return search


def flatten_device_buckets(device_buckets: list[dict]) -> list:
    flat = []
    for b in device_buckets:
        flat.extend([b["sents"], b["norms"], b["doc_idx"]])
        if "scales" in b:
            flat.append(b["scales"])
    return flat


def _bucket_topk_batched(q, q_norms, q_lens, bucket, k: int,
                         exact: bool = False, scan: str = "kernel"):
    """q: [B, Qmax, d]; -> (scores [B, k], doc idx [B, k]) for one bucket."""
    sents, norms, doc_idx = bucket["sents"], bucket["norms"], bucket["doc_idx"]
    bq, qmax, d = q.shape
    if "scales" in bucket and _kernel_route(bucket, scan):
        score = fused_l2max_scan_int8_batched(
            sents, bucket["scales"], norms, q, q_lens, qmax).t()    # [B, n]
        return _mask_and_topk(score, doc_idx, k)
    if bq == 1 and _kernel_route(bucket, scan):
        # a batch of one is a single query: the bf16 / f32 scan kernel
        score = fused_l2max_scan(sents, q[0], norms, q_lens[0],
                                 qadd=-q_norms[0])[None]
        return _mask_and_topk(score, doc_idx, k)
    require_fp32_matmul()
    if "scales" in bucket:
        sims = torch.einsum("bqd,nsd->bnsq", q.to(torch.bfloat16).float(),
                            sents.float())
        sims = sims * bucket["scales"][None, :, :, None]
    else:
        sims = torch.einsum("bqd,nsd->bnsq", q.to(sents.dtype).float(),
                            sents.float())
    qmask = torch.arange(qmax, device=q.device)[None, :] < q_lens[:, None]
    scores4 = 2.0 * sims - norms[None, :, :, None] - q_norms[:, None, None, :]
    scores4 = torch.where(qmask[:, None, None, :], scores4,
                          torch.full_like(scores4, NEG))
    return _mask_and_topk(scores4.amax(dim=(2, 3)), doc_idx, k)


def score_buckets_batched(buckets: list[dict], q, q_lens, k: int,
                          q_chunk: int | None = None, exact: bool = False,
                          scan: str = "kernel"):
    """Batched-query top-k over device bucket dicts (see score_buckets).

    q: [B, Qmax, d]; q_lens: int[B]; -> (scores [B, k], doc idx [B, k]).
    q_chunk bounds the [c, n, s, q] similarity intermediate of the plain
    product (must divide B); the int8 kernel keeps no such intermediate and
    then reads the bucket once a chunk.
    """
    _check_scan(scan)

    def _chunk(qc, qlc):
        qf = qc.float()
        q_norms = torch.sum(qf * qf, dim=2)
        vs, ds = [], []
        for b in buckets:
            v, dd = _bucket_topk_batched(qf, q_norms, qlc, b, k, exact, scan)
            vs.append(v)
            ds.append(dd)
        return _topk_padded(torch.cat(vs, dim=1), torch.cat(ds, dim=1), k)

    with torch.no_grad(), span("scan"):
        bsz = q.shape[0]
        if q_chunk is None or q_chunk >= bsz:
            return _chunk(q, q_lens)
        assert bsz % q_chunk == 0, (
            f"q_chunk={q_chunk} must divide the query batch {bsz}")
        parts = [_chunk(q[i:i + q_chunk], q_lens[i:i + q_chunk])
                 for i in range(0, bsz, q_chunk)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))


def make_dense_search_batched(n_buckets: int, k: int, int8: bool = False,
                              q_chunk: int | None = None,
                              exact: bool = False, scan: str = "kernel",
                              mesh=None):
    """Batched-query variant: amortizes the corpus read over a whole query
    batch -- the production serving shape.

    Returns fn(q [B, Qmax, d], q_lens [B] int, *bucket_arrays)
      -> (scores [B, k], doc_idx [B, k]), identical per-query results to
      make_dense_search.  q_chunk, scan: see `score_buckets_batched`.
    mesh: each rank scans its slices and the [B, k] blocks merge by one
      all_gather (`_merge_sharded_topk`); queries are the same on every rank.
    """
    def search(q, q_lens, *flat):
        buckets = _unflatten_buckets(flat, n_buckets, int8)
        v, d = score_buckets_batched(buckets, q, q_lens, k, q_chunk, exact,
                                     scan)
        if mesh is not None:
            v, d = _merge_sharded_topk(v, d, k, mesh)
        return _finish(v, d)
    return search
