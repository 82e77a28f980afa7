"""Tokenization & featurization (CPU-side) with the reference contract
(the port's own copy of aspire_tpu/text/tokenize.py: numpy only).

Re-implements the `prepare_bert_sentences` / `prepare_abstracts` contract
(examples/ex_aspire_consent.py:107-212, src/learning/batchers.py:456-630)
that every published aspire checkpoint was trained under:

  * a document is [title, sent_1, ..., sent_n]; the title is tokenized as
    sentence 0 but its token indices are EXCLUDED from the per-sentence lists;
  * token indices are +1-shifted to account for the [CLS] prepended later;
  * inputs are capped at 500 content tokens by truncating the final sentence
    (possibly to a prefix; empty prefixes are dropped);
  * [CLS] ... [SEP] wrapping, zero segment ids, 1/0 attention mask, pad with
    the tokenizer pad id.

The device-facing output replaces ragged `list(list(list(int)))` token-index
structures with a dense `sent_ids[b, t]` array (sentence index per token,
-1 elsewhere) that feeds `models.encoders.sentence_pool` -- one array, static
shape, no host->device index gymnastics.
"""
from __future__ import annotations

import dataclasses

import numpy as np

MAX_NUM_TOKS = 500  # reference cap: batchers.py:569, ex_aspire_consent.py:120


@dataclasses.dataclass
class TokenizedDoc:
    """Host-side tokenization result for one document."""

    token_ids: list[int]          # with [CLS]/[SEP]
    sent_token_idxs: list[list[int]]  # per abstract sentence (title excluded)

    @property
    def num_sents(self) -> int:
        return len(self.sent_token_idxs)


@dataclasses.dataclass
class FeatureBatch:
    """Static-shape arrays for the encoder.

    token_ids: i32[b, t]; attn_mask: i32[b, t]; seg_ids: i32[b, t];
    sent_ids: i32[b, t] (-1 outside abstract sentences); abs_lens: i32[b].
    """

    token_ids: np.ndarray
    attn_mask: np.ndarray
    seg_ids: np.ndarray
    sent_ids: np.ndarray
    abs_lens: np.ndarray

    @property
    def batch(self) -> int:
        return self.token_ids.shape[0]

    @property
    def seq_len(self) -> int:
        return self.token_ids.shape[1]


def tokenize_doc_sents(doc_sents: list[str], tokenizer,
                       max_num_toks: int = MAX_NUM_TOKS) -> TokenizedDoc:
    """Tokenize one document's sentences (title first) with the 500-token
    truncate-final-sentence rule and +1 CLS offset.

    Dispatches to the tokenizer's own `tokenize_doc_sents` when it has one
    (a native tokenizer)."""
    if hasattr(tokenizer, "tokenize_doc_sents"):
        return tokenizer.tokenize_doc_sents(doc_sents, max_num_toks=max_num_toks)
    all_token_ids: list[int] = []
    sent_idx_lists: list[list[int]] = []
    cur_len = 0
    for sent in doc_sents:
        toks = tokenizer.tokenize(sent)
        ids = tokenizer.convert_tokens_to_ids(toks)
        idxs = [cur_len + i + 1 for i in range(len(ids))]
        if cur_len + len(idxs) <= max_num_toks:
            sent_idx_lists.append(idxs)
            all_token_ids.extend(ids)
            cur_len += len(idxs)
        else:
            keep = len(idxs) - (cur_len + len(idxs) - max_num_toks)
            if keep > 0:
                sent_idx_lists.append(idxs[:keep])
                all_token_ids.extend(ids[:keep])
            break
    token_ids = tokenizer.build_inputs_with_special_tokens(token_ids_0=all_token_ids)
    # Exclude the title (sentence 0) from the per-sentence index lists.
    return TokenizedDoc(token_ids=token_ids, sent_token_idxs=sent_idx_lists[1:])


def _bucket_len(n: int, pad_multiple: int, cap: int) -> int:
    b = ((n + pad_multiple - 1) // pad_multiple) * pad_multiple
    return min(max(b, pad_multiple), cap)


def features_to_arrays(docs: list[TokenizedDoc], pad_id: int,
                       max_sents: int, pad_multiple: int = 64,
                       seq_len: int | None = None) -> FeatureBatch:
    """Pack tokenized docs into padded arrays.

    Sequence length is bucketed to `pad_multiple` (few distinct shapes) unless `seq_len` pins it.  Sentences beyond `max_sents`
    are dropped from `sent_ids` (their tokens stay in the input -- they still
    contextualize -- but pool to nothing), and `abs_lens` is clipped.
    """
    b = len(docs)
    longest = max(len(d.token_ids) for d in docs)
    t = seq_len if seq_len is not None else _bucket_len(longest, pad_multiple, 512)
    assert longest <= t, f"doc of length {longest} exceeds seq_len {t}"
    token_ids = np.full((b, t), pad_id, np.int32)
    attn = np.zeros((b, t), np.int32)
    seg = np.zeros((b, t), np.int32)
    sent_ids = np.full((b, t), -1, np.int32)
    abs_lens = np.zeros((b,), np.int32)
    for i, d in enumerate(docs):
        n = len(d.token_ids)
        token_ids[i, :n] = d.token_ids
        attn[i, :n] = 1
        abs_lens[i] = min(d.num_sents, max_sents)
        for s, idxs in enumerate(d.sent_token_idxs[:max_sents]):
            sent_ids[i, idxs] = s
    return FeatureBatch(token_ids=token_ids, attn_mask=attn, seg_ids=seg,
                        sent_ids=sent_ids, abs_lens=abs_lens)


def tokenize_abstracts(batch_abs: list[dict], tokenizer,
                       max_num_toks: int = MAX_NUM_TOKS) -> list[TokenizedDoc]:
    """TokenizedDocs for {'TITLE': str, 'ABSTRACT': list[str]} dicts.

    The ONE place the SPECTER-style "<title> [SEP] " prefix is built
    (ex_aspire_consent.py:196-200) -- callers that need lengths before
    packing (seq-bucket selection) tokenize here once and hand the same
    docs to features_to_arrays."""
    docs = []
    for ex in batch_abs:
        seqs = [ex["TITLE"] + " [SEP] "]
        seqs.extend(ex["ABSTRACT"])
        docs.append(tokenize_doc_sents(seqs, tokenizer, max_num_toks=max_num_toks))
    return docs


def prepare_abstracts(batch_abs: list[dict], tokenizer, max_sents: int = 24,
                      pad_multiple: int = 64, seq_len: int | None = None,
                      max_num_toks: int = MAX_NUM_TOKS,
                      return_docs: bool = False):
    """Featurize a batch of {'TITLE': str, 'ABSTRACT': list[str]} dicts.

    The title is prefixed as "<title> [SEP] " exactly like SPECTER/the
    reference (ex_aspire_consent.py:196-200).  With `return_docs=True` also
    returns the per-doc `TokenizedDoc`s (for entity-span bookkeeping).
    """
    if seq_len is not None:
        # a pinned sequence length bounds the content tokens it can hold:
        # without this clamp the 500-token default overflows any
        # seq_len < 502 ([CLS] + content + [SEP]) and the packing assert
        # fires mid-run, data-dependently
        max_num_toks = min(max_num_toks, seq_len - 2)
    docs = tokenize_abstracts(batch_abs, tokenizer, max_num_toks=max_num_toks)
    for d in docs:
        assert d.num_sents > 0, "abstract truncated to zero sentences"
    fb = features_to_arrays(docs, pad_id=tokenizer.pad_token_id,
                            max_sents=max_sents, pad_multiple=pad_multiple,
                            seq_len=seq_len)
    return (fb, docs) if return_docs else fb


def find_sublist_range(suplist: list, sublist: list) -> list[int] | None:
    """Positions of the FIRST occurrence of `sublist` inside `suplist`.

    Mirrors AspireContextNER.find_sublist_range
    (src/evaluation/utils/models.py:684-697); returns None when absent or
    when `sublist` is empty (the reference returns [] there, which its
    caller also treats as invalid).
    """
    m = len(sublist)
    if m == 0:
        return None
    for i in range(len(suplist) - m + 1):
        if suplist[i:i + m] == sublist:
            return list(range(i, i + m))
    return None


def ner_token_spans(batch_papers: list[dict], tokenizer,
                    docs: list[TokenizedDoc]) -> list[list[list[int]]]:
    """Global token indices for every NER entity, in sentence order.

    For each paper, returns one list per entity (flattened across sentences,
    preserving the ENTITIES order): the +1-CLS-shifted token indices of the
    entity's span inside its sentence context, or [] when the entity cannot
    be used.  An entity is unusable when (a) its tokenization does not occur
    as a sub-sequence of its sentence's tokenization (the entities were
    extracted with a different tokenizer), or (b) any of its tokens fall
    beyond the 500-token truncation -- the contract of
    AspireContextNER._get_ner_token_idxs
    (src/evaluation/utils/models.py:649-682).

    Deviation (documented): entities belonging to sentences that were
    truncated away entirely still get an (invalid, []) slot here, so the
    output always has one entry per entity; the reference's zip silently
    drops them, which desynchronizes its downstream facet filter.
    """
    out = []
    for paper, doc in zip(batch_papers, docs):
        spans: list[list[int]] = []
        for si, (ners, sent) in enumerate(zip(paper["ENTITIES"],
                                              paper["ABSTRACT"])):
            tok_idxs = (doc.sent_token_idxs[si]
                        if si < len(doc.sent_token_idxs) else [])
            sent_toks = tokenizer.tokenize(sent) if (tok_idxs and ners) else []
            for ner in ners:
                span: list[int] = []
                if tok_idxs:
                    rng = find_sublist_range(sent_toks, tokenizer.tokenize(ner))
                    if rng:
                        idxs = [tok_idxs[i] for i in rng if i < len(tok_idxs)]
                        if len(idxs) == len(rng):  # fully inside truncation
                            span = idxs
                spans.append(span)
        out.append(spans)
    return out


def spans_to_mask(batch_spans: list[list[list[int]]], seq_len: int,
                  max_ents: int | None = None,
                  pad_multiple: int = 8) -> np.ndarray:
    """Dense f32[b, max_ents, t] span-membership mask for device pooling.

    Entity e of doc b has 1.0 at its token positions; invalid entities are
    all-zero rows (they pool to a zero vector and are dropped host-side).
    A dense mask (not an id array) because spans may overlap."""
    b = len(batch_spans)
    if max_ents is None:
        longest = max((len(s) for s in batch_spans), default=0)
        max_ents = max(pad_multiple,
                       -(-max(longest, 1) // pad_multiple) * pad_multiple)
    mask = np.zeros((b, max_ents, seq_len), np.float32)
    for i, spans in enumerate(batch_spans):
        for e, span in enumerate(spans[:max_ents]):
            if span:
                mask[i, e, span] = 1.0
    return mask
