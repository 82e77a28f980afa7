"""Training-data readers: co-citation triple jsonl -> static-shape batches
(the port's own copy of aspire_tpu/data/readers.py: numpy only).

Consumes the reference's training file contracts
(src/pre_process/pre_proc_cocits.py:300-312,495-521): one json per line with
  query:       {'TITLE': str, 'ABSTRACT': [str, ...], optional 'cc_align'/'abs_align'}
  pos_context: same shape
  neg_context: present only in dev files (frozen pre-sampled negatives)

and assembles numpy superbatches [n_micro, micro_batch, ...] in the layout
`Trainer.train` takes.  Sequence length is FIXED per stream (default 512), as
in the JAX package, so that both packages see the same arrays; the reference
pads each batch to its own longest document (batchers.py:217-252).
"""
from __future__ import annotations

import codecs
import json
from typing import Iterator

import numpy as np

from ..core.config import ModelHParams
from ..text.tokenize import prepare_abstracts, FeatureBatch


def read_jsonl(path: str) -> Iterator[dict]:
    with codecs.open(path, "r", "utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def _as_doc(x) -> dict:
    """Normalize an example field to the abstract-dict contract.

    The sentence-model files (train/dev-coppsent.jsonl,
    pre_proc_cocits.py:300-312) store query/pos_context/neg_context as RAW
    SENTENCE STRINGS; abstract files store {'TITLE', 'ABSTRACT', ...} dicts
    (extra keys like citing_contexts ride along untouched)."""
    if isinstance(x, str):
        return {"TITLE": "", "ABSTRACT": [x]}
    return x


def _fb_to_dict(fb: FeatureBatch) -> dict:
    return {
        "token_ids": fb.token_ids, "attn_mask": fb.attn_mask,
        "sent_ids": fb.sent_ids, "abs_lens": fb.abs_lens,
    }


def _featurize(texts: list[dict], tokenizer, hp: ModelHParams, seq_len: int,
               align_type: str | None = None, docs=None) -> dict:
    """Pack one micro batch; `docs` supplies pre-tokenized TokenizedDocs
    (the bucketed path tokenizes once to measure lengths)."""
    if docs is None:
        fb = prepare_abstracts(texts, tokenizer, max_sents=hp.max_sents,
                               seq_len=seq_len)
    else:
        from ..text.tokenize import features_to_arrays
        fb = features_to_arrays(docs, pad_id=tokenizer.pad_token_id,
                                max_sents=hp.max_sents, seq_len=seq_len)
    out = _fb_to_dict(fb)
    if align_type is not None and all(align_type in t for t in texts):
        out["align"] = np.asarray([t[align_type] for t in texts], np.int32)
    return out


class TripleStream:
    """Yields train superbatches from a triple jsonl file.

    Each yield: {'query': feats, 'pos': feats} with arrays stacked to
    [n_micro, micro_batch, ...].  Trailing examples that do not fill a full
    superbatch are dropped (static shapes; the reference similarly lets its
    final accumulation group go unused, trainer.py:246-248).
    """

    def __init__(self, path: str, tokenizer, hp: ModelHParams,
                 micro_batch: int, n_micro: int, seq_len: int = 512,
                 align_type: str | None = None, max_examples: int | None = None,
                 shuffle_seed: int | None = None, shuffle_buffer: int = 50_000,
                 seq_buckets: tuple[int, ...] | None = None):
        self.path = path
        self.tokenizer = tokenizer
        self.hp = hp
        self.micro_batch = micro_batch
        self.n_micro = n_micro
        self.seq_len = seq_len
        self.align_type = align_type
        self.max_examples = max_examples
        self.shuffle_seed = shuffle_seed
        self.shuffle_buffer = shuffle_buffer
        # seq_buckets: opt-in length bucketing, e.g. (192, 320, 512).  Each
        # micro batch is featurized at the smallest bucket that fits its
        # longest doc, and micros accumulate per bucket until a superbatch
        # fills -- most batches then run at short sequence lengths, at the
        # cost of slight example reordering across buckets.
        self.seq_buckets = tuple(sorted(seq_buckets)) if seq_buckets else None
        self.epoch = 0

    def _examples(self) -> Iterator[dict]:
        """Stream examples, with a seeded buffer shuffle when requested
        (the per-epoch `shuf` of run_main_fsim-ddp.sh:51-90; seed varies by
        epoch so successive passes see different orders)."""
        if self.shuffle_seed is None:
            yield from read_jsonl(self.path)
            return
        import random
        rng = random.Random(self.shuffle_seed + self.epoch)
        self.epoch += 1
        buf: list[dict] = []
        for ex in read_jsonl(self.path):
            buf.append(ex)
            if len(buf) >= self.shuffle_buffer:
                rng.shuffle(buf)
                yield from buf
                buf = []
        rng.shuffle(buf)
        yield from buf

    def _bucketed_micro(self, queries, positives) -> tuple[int, dict]:
        """Tokenize ONCE, pick the smallest covering bucket, pack.

        Tokenization is the CPU hot loop (the native tokenizer exists for
        it), so bucket selection reuses the same TokenizedDocs the arrays
        are packed from.  The truncation cap is the largest bucket, so the
        longest doc always fits it."""
        from ..text.tokenize import tokenize_abstracts, MAX_NUM_TOKS
        # same truncation the non-bucketed path applies (prepare_abstracts
        # clamps to min(MAX_NUM_TOKS, seq_len-2)): the buckets must change
        # only the PADDING, never which tokens a doc trains on
        cap = min(MAX_NUM_TOKS, self.seq_buckets[-1] - 2)
        qd = tokenize_abstracts(queries, self.tokenizer, max_num_toks=cap)
        pd = tokenize_abstracts(positives, self.tokenizer, max_num_toks=cap)
        longest = max(len(t.token_ids) for t in qd + pd)
        bucket = next(b for b in self.seq_buckets if longest <= b)
        return bucket, {
            "query": _featurize(queries, self.tokenizer, self.hp, bucket,
                                docs=qd),
            "pos": _featurize(positives, self.tokenizer, self.hp, bucket,
                              self.align_type, docs=pd),
        }

    def __iter__(self) -> Iterator[dict]:
        by_bucket: dict[int, list[dict]] = {}
        queries: list[dict] = []
        positives: list[dict] = []
        n_seen = 0
        for ex in self._examples():
            if self.max_examples is not None and n_seen >= self.max_examples:
                break
            queries.append(_as_doc(ex["query"]))
            positives.append(_as_doc(ex["pos_context"]))
            n_seen += 1
            if len(queries) == self.micro_batch:
                if self.seq_buckets:
                    bucket, micro = self._bucketed_micro(queries, positives)
                else:
                    bucket = self.seq_len
                    micro = {
                        "query": _featurize(queries, self.tokenizer, self.hp,
                                            bucket),
                        "pos": _featurize(positives, self.tokenizer, self.hp,
                                          bucket, self.align_type),
                    }
                queries, positives = [], []
                micros = by_bucket.setdefault(bucket, [])
                micros.append(micro)
                if len(micros) == self.n_micro:
                    yield _stack_micros(micros)
                    by_bucket[bucket] = []


def _stack_micros(micros: list[dict]) -> dict:
    out: dict = {}
    for part in micros[0]:
        out[part] = {k: np.stack([m[part][k] for m in micros])
                     for k in micros[0][part]}
    return out


def dev_batches(path: str, tokenizer, hp: ModelHParams, batch_size: int,
                seq_len: int = 512, align_type: str | None = None,
                max_examples: int | None = None) -> Iterator[dict]:
    """Flat dev batches with the frozen explicit negatives.

    Incomplete trailing batches are dropped (static shapes; dev loss stays
    comparable across checks because the same prefix is always used).
    """
    queries: list[dict] = []
    positives: list[dict] = []
    negatives: list[dict] = []
    n_seen = 0
    for ex in read_jsonl(path):
        if max_examples is not None and n_seen >= max_examples:
            break
        queries.append(_as_doc(ex["query"]))
        positives.append(_as_doc(ex["pos_context"]))
        negatives.append(_as_doc(ex["neg_context"]))
        n_seen += 1
        if len(queries) == batch_size:
            yield {
                "query": _featurize(queries, tokenizer, hp, seq_len),
                "pos": _featurize(positives, tokenizer, hp, seq_len, align_type),
                "neg": _featurize(negatives, tokenizer, hp, seq_len),
            }
            queries, positives, negatives = [], [], []
