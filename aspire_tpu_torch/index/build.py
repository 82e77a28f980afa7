"""Flat multi-vector corpus index: build + storage (counterpart of
aspire_tpu/index/build.py).

  layout: [n_shards, shard_len, dim] sentence matrix (optionally bf16), int32
  [n_shards, shard_len] doc-id labels and per-doc lengths.  Documents are
  partitioned contiguously into `n_shards` shards balanced by sentence count
  (sentences of one doc never straddle shards), each padded to a common size.
  One card searches an index of any shard count (`l2max_search` flattens the
  shards, index/serve.py); a serving mesh of n_shards ranks gives rank r
  shard r (`device_arrays(mesh=)`, `make_sharded_search`).

The files are the ones the JAX package writes and reads (sents.npy,
doc_ids.npy, doc_lens.npy, meta.json, pids.json, pid2idx.json): an index saved
by either package loads in the other.  bfloat16 lives on the host as the uint16
view those files store, marked by `dtype == "bfloat16"`, and crosses to torch
by ``.view(torch.bfloat16)``.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import torch

from ..core.types import require_device

BF16 = "bfloat16"


def f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> the uint16 bit patterns of bfloat16, round to nearest even."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rounded = (u + (np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))) \
        >> np.uint32(16)
    # a NaN must stay one: rounding may carry its mantissa away
    rounded = np.where(np.isnan(x), np.uint32(0x7FC0), rounded)
    return rounded.astype(np.uint16)


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 bit patterns -> float32 (exact)."""
    return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)


def is_bf16(dtype) -> bool:
    return isinstance(dtype, str) and dtype == BF16 or dtype is torch.bfloat16


def host_rows_to_device(arr: np.ndarray, bf16: bool, device) -> torch.Tensor:
    """A host row array (float32, int8, or uint16 bits of bfloat16) as a
    tensor on `device` (a read-only array, such as a mapped file's slice,
    is copied first)."""
    arr = np.require(arr, requirements=("C_CONTIGUOUS", "WRITEABLE"))
    if bf16:
        return torch.from_numpy(arr.view(np.int16)).to(device).view(torch.bfloat16)
    return torch.from_numpy(arr).to(device)


def save_pids(path: pathlib.Path, pids: list) -> None:
    """Persist the doc-idx -> paper-id map (shared by all index types).

    pid2idx.json keeps the reference file contract
    (pre_proc_buildreps.py:309-439), but JSON object KEYS are always
    strings -- integer paper ids would silently load back as strings and
    miss every gold-pool lookup.  The ordered pids.json list preserves
    types and is preferred on load."""
    with open(path / "pid2idx.json", "w") as f:
        json.dump({pid: i for i, pid in enumerate(pids)}, f)
    with open(path / "pids.json", "w") as f:
        json.dump(list(pids), f)


def load_pids(path: pathlib.Path) -> list:
    """Inverse of save_pids; falls back to pid2idx.json for old indexes."""
    pids_path = path / "pids.json"
    if pids_path.exists():
        with open(pids_path) as f:
            return json.load(f)
    with open(path / "pid2idx.json") as f:
        pid2idx = json.load(f)
    pids = [None] * len(pid2idx)
    for pid, i in pid2idx.items():
        pids[i] = pid
    return pids


@dataclasses.dataclass
class MultiVecIndex:
    """Host-side index representation."""

    sents: np.ndarray       # [n_shards, shard_len, dim]; uint16 bits when bf16
    doc_ids: np.ndarray     # [n_shards, shard_len] int32; -1 on padding
    doc_lens: np.ndarray    # [n_docs] int32
    pids: list              # doc idx -> external paper id
    dtype: str = "float32"  # "float32" or "bfloat16"

    @property
    def n_docs(self) -> int:
        return len(self.pids)

    @property
    def n_shards(self) -> int:
        return self.sents.shape[0]

    @property
    def dim(self) -> int:
        return self.sents.shape[-1]

    def sents_f32(self) -> np.ndarray:
        """The stored rows as float32 on the host."""
        if self.dtype == BF16:
            return bf16_bits_to_f32(self.sents)
        return np.asarray(self.sents, np.float32)

    def save(self, path: str | pathlib.Path) -> None:
        path = pathlib.Path(path)
        path.mkdir(parents=True, exist_ok=True)
        np.save(path / "sents.npy", self.sents)
        np.save(path / "doc_ids.npy", self.doc_ids)
        np.save(path / "doc_lens.npy", self.doc_lens)
        save_pids(path, self.pids)
        with open(path / "meta.json", "w") as f:
            json.dump({"sent_dtype": self.dtype}, f)

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "MultiVecIndex":
        path = pathlib.Path(path)
        sents = np.load(path / "sents.npy")
        dtype = str(np.dtype(sents.dtype))
        meta_path = path / "meta.json"
        if meta_path.exists():
            with open(meta_path) as f:
                meta = json.load(f)
            if BF16 in meta.get("sent_dtype", ""):
                dtype = BF16
        return cls(sents=sents, doc_ids=np.load(path / "doc_ids.npy"),
                   doc_lens=np.load(path / "doc_lens.npy"),
                   pids=load_pids(path), dtype=dtype)

    def device_arrays(self, device="cuda", mesh=None):
        """(sents, doc_ids) as tensors on one device ([n_shards, L, ...]), or
        under a serving mesh shard r ([L, ...]) on rank r's device."""
        if mesh is None:
            dev = require_device(device)
            return (host_rows_to_device(self.sents, self.dtype == BF16, dev),
                    torch.from_numpy(self.doc_ids).to(dev))
        if mesh.size("shard") != self.n_shards:
            raise ValueError(f"the index has {self.n_shards} shards, the mesh "
                             f"{mesh.size('shard')} shard ranks")
        r = mesh.index("shard")
        return (host_rows_to_device(self.sents[r], self.dtype == BF16,
                                    mesh.device),
                torch.from_numpy(self.doc_ids[r]).to(mesh.device))


def build_index_from_reps(doc_reps: list[np.ndarray], pids: list,
                          n_shards: int = 1, dtype="float32") -> MultiVecIndex:
    """Assemble an index from per-doc [num_sents, dim] sentence matrices.

    Documents are greedily packed into `n_shards` contiguous shards balanced
    by sentence count; shards pad to a common length with zero vectors and
    doc_id -1 (zero reps at L2 distance ~|q| never win the max against real
    sentences, and -1 labels are dropped by the segment reduction).
    dtype: "float32" (or np.float32) or "bfloat16" (or torch.bfloat16).
    """
    assert len(doc_reps) == len(pids)
    bf16 = is_bf16(dtype)
    doc_lens = np.asarray([r.shape[0] for r in doc_reps], np.int32)
    dim = doc_reps[0].shape[1]
    total = int(doc_lens.sum())

    shards: list[list[int]] = [[] for _ in range(n_shards)]
    shard_fill = np.zeros(n_shards, np.int64)
    si = 0
    remaining = total
    for di, ln in enumerate(doc_lens):
        # adaptive target (remaining work over remaining shards) and never
        # advance off an EMPTY shard: one oversized doc must not strand
        # empty shards behind OR after it -- every shard pads to the max
        # fill, so an empty shard inflates memory/scan work for all of them
        target = -(-remaining // (n_shards - si))
        if shard_fill[si] > 0 and shard_fill[si] + ln > target \
                and si < n_shards - 1:
            si += 1
        shards[si].append(di)
        shard_fill[si] += int(ln)
        remaining -= int(ln)

    shard_len = int(max(shard_fill.max(), 1))
    shard_len = -(-shard_len // 128) * 128
    sents = np.zeros((n_shards, shard_len, dim), np.float32)
    doc_ids = np.full((n_shards, shard_len), -1, np.int32)
    for si, doc_idxs in enumerate(shards):
        off = 0
        for di in doc_idxs:
            ln = int(doc_lens[di])
            sents[si, off:off + ln] = doc_reps[di]
            doc_ids[si, off:off + ln] = di
            off += ln
    if bf16:
        sents = f32_to_bf16_bits(sents)
    return MultiVecIndex(sents=sents, doc_ids=doc_ids, doc_lens=doc_lens,
                         pids=list(pids), dtype=BF16 if bf16 else "float32")


def encode_corpus(model, corpus: list[dict], tokenizer, batch_size: int = 32,
                  seq_len: int = 512, max_sents: int = 24,
                  quantize: bool = False):
    """Stream a corpus of {'TITLE', 'ABSTRACT'} docs through the encoder.

    model: a module of the port that carries its own parameters: a document
    model (models/doc_models.build_model), whose ``encode(feats)`` gives
    (cls [b, d], MultiVec or None), or a bare `ConSentEncoder`, which maps
    (token_ids, attn_mask, sent_ids) to (cls, sent_reps [b, max_sents, d]).
    It runs in eval mode under ``torch.no_grad()`` on the device its
    parameters lie on.  Batches have one fixed shape (the last is padded with
    its last doc).  CLS-only families return no sentence reps: each document
    then gets a [0, dim] array.

    Returns (per-doc [num_sents, dim] float32 arrays, [n_docs, dim] CLS reps).
    With `quantize` the sentences are quantised on the device
    (index/dense.quantize_sentences) and each document comes back as an
    (int8 [num_sents, dim], float32 scales [num_sents]) pair for
    `build_dense_index_prequantized`: one byte an element crosses to the host.
    """
    from ..text.tokenize import prepare_abstracts
    from .dense import quantize_sentences

    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    doc_reps: list = []
    cls_reps: list[np.ndarray] = []
    try:
        with torch.no_grad():
            for start in range(0, len(corpus), batch_size):
                chunk = corpus[start:start + batch_size]
                pad_n = batch_size - len(chunk)
                fb = prepare_abstracts(chunk + [chunk[-1]] * pad_n, tokenizer,
                                       max_sents=max_sents, seq_len=seq_len)
                feats = {"token_ids": torch.from_numpy(fb.token_ids).to(device).long(),
                         "attn_mask": torch.from_numpy(fb.attn_mask).to(device),
                         "sent_ids": torch.from_numpy(fb.sent_ids).to(device).long(),
                         "abs_lens": torch.from_numpy(fb.abs_lens).to(device)}
                lens = fb.abs_lens
                if hasattr(model, "encode"):
                    cls, mv = model.encode(feats)
                    if mv is None:
                        embed = cls.new_zeros((batch_size, 1, cls.shape[-1]))
                        lens = np.zeros(batch_size, np.int32)
                    else:
                        embed = mv.embed
                else:
                    cls, embed = model(feats["token_ids"], feats["attn_mask"],
                                       feats["sent_ids"])
                cls = cls.float().cpu().numpy()
                if quantize:
                    xi, sc = quantize_sentences(embed.float())
                    xi, sc = xi.cpu().numpy(), sc.cpu().numpy()
                else:
                    embed = embed.float().cpu().numpy()
                for i in range(len(chunk)):
                    ln = int(lens[i])
                    if quantize:
                        doc_reps.append((xi[i, :ln].copy(), sc[i, :ln].copy()))
                    else:
                        doc_reps.append(np.asarray(embed[i, :ln], np.float32))
                    cls_reps.append(np.asarray(cls[i], np.float32))
    finally:
        model.train(was_training)
    return doc_reps, np.stack(cls_reps) if cls_reps else np.zeros((0, 0))
