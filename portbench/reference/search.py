"""Plain l2max first stage over a multi-vector index, in float32 (TF32 off):
per document, the least squared distance between a real query sentence and
a real document sentence.  Imports nothing of the program.

The index is read as stored: int8 values and a scale a sentence, per
document its count of sentences (`doc_sents`), and where its rows lie
(`locate`, worked out here from the counts and the bucket sizes).  Norms are
computed here from the dequantised values.  A bf16 store (no scales) is read
as its values.

`bits=4` is the control: each sentence re-quantised to int4 (symmetric,
scale max|x| / 7) before the product, the step below int8."""
from __future__ import annotations

import torch

ROWS = 1 << 13          # document rows a block


def locate(doc_sents: torch.Tensor, sizes: list) -> tuple:
    """(bucket, row) of every document: the smallest bucket size that holds
    it, rows in document order within a bucket."""
    bucket = torch.full_like(doc_sents, -1)
    row = torch.zeros_like(doc_sents)
    lower, live = 0, 0
    for s in sizes:
        member = (doc_sents > lower) & (doc_sents <= s)
        if bool(member.any()):
            idx = torch.nonzero(member).flatten()
            bucket[idx] = live
            row[idx] = torch.arange(idx.numel(), device=idx.device,
                                    dtype=row.dtype)
            live += 1
        lower = s
    return bucket, row


def dequantise(sents: torch.Tensor, scales: torch.Tensor | None,
               bits: int = 8) -> torch.Tensor:
    x = sents.float()
    if scales is not None:
        x = x * scales[..., None]
    if bits == 4:
        sc = x.abs().amax(-1, keepdim=True) / 7.0
        sc = torch.where(sc > 0, sc, torch.ones_like(sc))
        x = torch.clamp(torch.round(x / sc), -7, 7) * sc
    return x


def doc_distances(q: torch.Tensor, q_lens: torch.Tensor, buckets: list,
                  doc_sents: torch.Tensor, sizes: list, bits: int = 8) -> torch.Tensor:
    """Squared l2max distance of every query to every document: f32 [B, n_docs].

    q: f32 [B, qmax, d], the first q_lens[b] rows real; buckets: per bucket
    {"sents": [rows, s, d] int8 or bf16, optional "scales": [rows, s]}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    bsz, qmax, d = q.shape
    real = torch.arange(qmax, device=q.device)[None, :] < q_lens[:, None].long()
    qr = q[real]                                         # [R, d]
    owner = torch.nonzero(real)[:, 0]                    # [R] -> query
    qq = (qr * qr).sum(-1)
    bucket, row = locate(doc_sents.long(), sizes)
    out = torch.full((bsz, doc_sents.numel()), float("inf"), device=q.device)
    for bi, b in enumerate(buckets):
        docs = torch.nonzero(bucket == bi).flatten()
        rows_of = row[docs]
        s = b["sents"].shape[1]
        for i in range(0, docs.numel(), ROWS):
            sel, rr = docs[i:i + ROWS], rows_of[i:i + ROWS]
            x = dequantise(b["sents"][rr],
                           b["scales"][rr] if "scales" in b else None, bits)
            xx = (x * x).sum(-1)                         # [r, s]
            qx = torch.matmul(x.reshape(-1, d), qr.t()).view(-1, s, qr.shape[0])
            d2 = (xx[:, :, None] + qq[None, None, :] - 2.0 * qx).clamp_min(0.0)
            slot_live = (torch.arange(s, device=q.device)[None, :]
                         < doc_sents[sel].long()[:, None])
            d2 = torch.where(slot_live[:, :, None], d2,
                             torch.full_like(d2, float("inf")))
            per = d2.amin(dim=1)                         # [r, R]
            best = torch.full((per.shape[0], bsz), float("inf"),
                              device=q.device)
            best.scatter_reduce_(1, owner[None, :].expand_as(per), per,
                                 "amin", include_self=True)
            out[:, sel] = best.t()
    return out
