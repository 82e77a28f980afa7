"""Whole-abstract (CLS) dense retrieval (counterpart of
aspire_tpu/index/cls.py).

The bi-encoder models (cospecter/specter) rank with a single CLS vector per
document; the reference does this with sklearn brute NearestNeighbors on
host numpy (pp_gen_nearest.py:638-726).  Here: one [B, d] x [d, n] product in
true float32 + top-k on the device, or on each rank of a serving mesh over its
rows with one all_gather merge (index/dense._merge_sharded_topk).  No kernel
of the TPU package sits on this path, so none is written for it.

`ClsIndex` persists a corpus of CLS reps with the same file contract as the
multi-vector indexes (cls_reps.npy, cls_norms.npy, meta.json, pids.json,
pid2idx.json): an index saved by either package loads in the other.  bfloat16
lives on the host as uint16 bits.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import torch

from ..core.types import require_device
from ..ops.cdist import require_fp32_matmul
from ..parallel.mesh import local_slice
from .build import (BF16, bf16_bits_to_f32, f32_to_bf16_bits,
                    host_rows_to_device, is_bf16, load_pids, save_pids)
from .dense import _merge_sharded_topk, _topk_padded


def pack_cls_index(cls_reps: np.ndarray, n_shards: int = 1, dtype=None):
    """[n, d] float reps -> (reps [n_pad, d] (uint16 bits when bf16), norms
    [n_pad] f32).  dtype: "bfloat16" (default) or "float32".

    Pads with +inf-norm dummy rows so they never rank."""
    bf16 = dtype is None or is_bf16(dtype)
    n, d = cls_reps.shape
    n_pad = -(-n // (128 * n_shards)) * (128 * n_shards)
    reps = np.zeros((n_pad, d), np.float32)
    reps[:n] = cls_reps
    norms = np.full((n_pad,), np.float32(np.inf), np.float32)
    if bf16:
        reps = f32_to_bf16_bits(reps)
        stored = bf16_bits_to_f32(reps[:n])
    else:
        stored = reps[:n]
    norms[:n] = np.einsum("nd,nd->n", stored, stored)
    return reps, norms


def _local_topk(q, reps, norms, k: int):
    """[B, d] queries x [L, d] reps -> pad-aware top-k of the neg-squared-L2
    scores: ([B, k] scores, [B, k] row ids, -1 where the pool holds fewer than
    k rows).  True float32: this top-k IS the final CLS ranking (no rerank
    stage shields it)."""
    require_fp32_matmul()
    qf = q.float()
    sims = torch.matmul(q.to(reps.dtype).float(), reps.float().t())
    score = 2.0 * sims - norms[None, :] - torch.sum(qf * qf, dim=1)[:, None]
    idx = torch.arange(score.shape[1], dtype=torch.int32,
                       device=score.device).expand(score.shape)
    return _topk_padded(score, idx, k)


def _finish(v, i):
    """neg-sq-L2 -> -L2 scores; pad slots (+inf-norm rows score -inf, short
    pools carry -1 from _topk_padded) come back as doc index -1."""
    idx = torch.where(torch.isneginf(v) | (i < 0), torch.full_like(i, -1), i)
    return -torch.sqrt(torch.clamp_min(-v, 0.0)), idx


def make_cls_search_batched(k: int, q_chunk: int | None = None, mesh=None):
    """Batched CLS search: fn(q [B, d], reps [n_pad, d], norms [n_pad]) ->
    (scores [B, k], doc idx [B, k]; -1 at pad slots).

    The ONE CLS search implementation -- `cls_search` and
    `make_sharded_cls_search` are its B=1 cases.  Pad slots are dedicated
    +inf-norm ROWS and short shards or pools pad with -1 (`_topk_padded`), so
    ANY k is safe -- k larger than a rank's rows or the whole corpus returns
    -1 fillers, never a duplicate or phantom doc.

    q_chunk: bound the [c, rows] f32 score intermediate by scanning the
    query batch in chunks of c (must divide B).
    mesh: reps and norms are this rank's contiguous rows
    (ClsIndex.device_arrays(mesh=)); each rank's top-k, its row ids made
    global, merges with the others' by one all_gather of [B, k] blocks.
    """
    def chunk(qc, reps, norms):
        v, i = _local_topk(qc, reps, norms, k)
        if mesh is not None:
            first = mesh.index("shard") * reps.shape[0]
            i = torch.where(i >= 0, i + first, torch.full_like(i, -1))
            v, i = _merge_sharded_topk(v, i, k, mesh)
        return v, i

    def search(q, reps, norms):
        with torch.no_grad():
            bsz = q.shape[0]
            if q_chunk is None or q_chunk >= bsz:
                return _finish(*chunk(q, reps, norms))
            assert bsz % q_chunk == 0, (
                f"q_chunk={q_chunk} must divide the query batch {bsz}")
            parts = [chunk(q[i:i + q_chunk], reps, norms)
                     for i in range(0, bsz, q_chunk)]
            return _finish(torch.cat([p[0] for p in parts]),
                           torch.cat([p[1] for p in parts]))
    return search


def make_sharded_cls_search(mesh, k: int):
    """Single-query sharded CLS search (B=1 of make_cls_search_batched):
    fn(q [d], reps, norms) -> (scores [k], doc idx [k])."""
    search = make_cls_search_batched(k, mesh=mesh)

    def fn(q, reps, norms):
        v, i = search(q[None], reps, norms)
        return v[0], i[0]

    return fn


def cls_search(q, reps, norms, k: int):
    """-L2 top-k for ONE query CLS vector (B=1 of the batched path).
    q: [d]; reps: [n, d]."""
    with torch.no_grad():
        v, i = _finish(*_local_topk(q[None], reps, norms, k))
    return v[0], i[0]


@dataclasses.dataclass
class ClsIndex:
    """Host-side CLS-rep corpus index (one vector per document).

    Row = global doc index; +inf-norm pad rows at the tail never rank.  The
    row count pads to a 128-multiple.
    """

    reps: np.ndarray     # [n_pad, d]; uint16 bits when bf16
    norms: np.ndarray    # [n_pad] f32; +inf on pad rows
    pids: list
    rep_dtype: str = BF16

    @property
    def n_docs(self) -> int:
        return len(self.pids)

    @property
    def dim(self) -> int:
        return self.reps.shape[-1]

    def save(self, path: str | pathlib.Path) -> None:
        path = pathlib.Path(path)
        path.mkdir(parents=True, exist_ok=True)
        np.save(path / "cls_reps.npy", self.reps)
        np.save(path / "cls_norms.npy", self.norms)
        save_pids(path, self.pids)
        with open(path / "meta.json", "w") as f:
            json.dump({"index_type": "cls", "rep_dtype": self.rep_dtype}, f)

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "ClsIndex":
        path = pathlib.Path(path)
        with open(path / "meta.json") as f:
            meta = json.load(f)
        reps = np.load(path / "cls_reps.npy")
        bf16 = BF16 in meta.get("rep_dtype", "")
        return cls(reps=reps, norms=np.load(path / "cls_norms.npy"),
                   pids=load_pids(path),
                   rep_dtype=BF16 if bf16 else str(np.dtype(reps.dtype)))

    def device_arrays(self, device="cuda", mesh=None):
        """(reps, norms) as tensors on one device, or this rank's contiguous
        rows of them on its device under a serving mesh (the 128-row padding
        splits over any shard count that divides it)."""
        dev = require_device(device) if mesh is None else mesh.device
        rows = (slice(None) if mesh is None
                else local_slice(len(self.norms), mesh, "shard"))
        return (host_rows_to_device(self.reps[rows], self.rep_dtype == BF16,
                                    dev),
                torch.from_numpy(self.norms[rows]).to(dev))


def build_cls_index(cls_reps: np.ndarray, pids: list, dtype=None) -> ClsIndex:
    """[n, d] CLS reps -> persisted/servable ClsIndex (default bf16 storage;
    norms always f32 from the stored values so search scores match what the
    storage dtype can express).  Rows pad to a 128-multiple."""
    assert len(cls_reps) == len(pids)
    reps, norms = pack_cls_index(np.asarray(cls_reps, np.float32), n_shards=1,
                                 dtype=dtype)
    bf16 = dtype is None or is_bf16(dtype)
    return ClsIndex(reps=reps, norms=norms, pids=list(pids),
                    rep_dtype=BF16 if bf16 else "float32")
