"""Byte-level BPE (GPT-2's, RoBERTa's), the tokenizer of the `sbrobertanli`
baseline, with the ids of Hugging Face's ``RobertaTokenizerFast``.

Four parts, as GPT-2's encoder has them:

* the byte -> unicode table (`bytes_to_unicode`): every byte of a word's
  UTF-8 gets a printable character, so merges work on strings;
* the pre-tokenizer, GPT-2's pattern
  ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``
  as a hand-written scan (`pre_tokenize`): Python's ``re`` has no ``\\p{L}``
  and the card's machine has no ``regex`` package.  Letters and numbers are
  the Unicode categories L* and N* from ``unicodedata`` (not
  ``str.isalpha`` / ``str.isnumeric``: ``isnumeric`` holds for CJK
  ideographs such as U+4E00); whitespace is Unicode's White_Space property
  (not ``str.isspace``, which also holds for U+001C-U+001F).  The Unicode
  version is that of the host's Python;
* ranked merges from merges.txt, the lowest rank first;
* a cache of each word's ids.

``add_prefix_space`` is False, as RobertaTokenizerFast has it.  The special
tokens of tokenizer_config.json (``<s>``, ``</s>``, ``<pad>``, ``<unk>``,
``<mask>``) are split out of the text before the pre-tokenizer, as HF's added
tokens are; ``<mask>`` takes the whitespace before it (its ``lstrip``).
"""
from __future__ import annotations

import json
import pathlib
import unicodedata

import numpy as np

from .fast import special_tokens

# Unicode's White_Space property (PropList.txt), what \s matches in the
# pattern's engine
WHITE_SPACE = frozenset(
    [chr(c) for c in range(0x09, 0x0E)]
    + [chr(c) for c in (0x20, 0x85, 0xA0, 0x1680, 0x2028, 0x2029, 0x202F,
                        0x205F, 0x3000)]
    + [chr(c) for c in range(0x2000, 0x200B)])

CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def bytes_to_unicode() -> dict:
    """GPT-2's table: printable Latin-1 bytes map to themselves, the other
    bytes to 256, 257, ... in byte order."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    table, extra = {}, 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + extra)
            extra += 1
    return table


def _kind(ch: str) -> str:
    """'L' letter, 'N' number, 'S' white space, 'O' anything else."""
    if ch in WHITE_SPACE:
        return "S"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "O"


def pre_tokenize(text: str) -> list[str]:
    """The pattern's matches in order, leftmost alternative first: the words
    that BPE then splits (their concatenation is the text)."""
    kinds = [_kind(c) for c in text]
    n = len(text)
    out = []
    i = 0

    def run(j: int, kind: str) -> int:
        while j < n and kinds[j] == kind:
            j += 1
        return j

    while i < n:
        if text[i] == "'":
            hit = next((c for c in CONTRACTIONS if text.startswith(c, i)), None)
            if hit:
                out.append(hit)
                i += len(hit)
                continue
        # ' ?\p{L}+', ' ?\p{N}+', ' ?[^\s\p{L}\p{N}]+': an optional ASCII
        # space, then a run of one class (the space's own class is 'S', so a
        # space never starts the run itself)
        start = i + 1 if text[i] == " " and i + 1 < n else i
        kind = kinds[start]
        j = start if kind == "S" else run(start, kind)
        if j > start:
            out.append(text[i:j])
            i = j
            continue
        # '\s+(?!\S)' then '\s+': a run of white space leaves its last
        # character to the next word when one follows
        j = run(i, "S")
        if j < n and j - i > 1:
            j -= 1
        out.append(text[i:j])
        i = j
    return out


class ByteLevelBPE:
    """RoBERTa's tokenizer from vocab.json + merges.txt.

    encode(text) -> int32 ids without special tokens;
    build_inputs_with_special_tokens(ids) -> <s> ids </s>;
    pad_token_id: the vocab's <pad> (1 in RoBERTa's).
    """

    def __init__(self, vocab: dict, merges: list[tuple[str, str]],
                 bos_token: str = "<s>", eos_token: str = "</s>",
                 unk_token: str = "<unk>", pad_token: str = "<pad>",
                 mask_token: str = "<mask>"):
        self.vocab = vocab
        self.ranks = {pair: r for r, pair in enumerate(merges)}
        self.byte_char = bytes_to_unicode()
        specials = {"bos": bos_token, "eos": eos_token, "unk": unk_token,
                    "pad": pad_token, "mask": mask_token}
        missing = {k: t for k, t in specials.items() if t not in vocab}
        if missing:
            raise ValueError(f"special tokens not in the vocab: {missing}")
        ids = {k: vocab[t] for k, t in specials.items()}
        self.cls_token_id = self.bos_token_id = ids["bos"]
        self.sep_token_id = self.eos_token_id = ids["eos"]
        self.unk_token_id, self.pad_token_id = ids["unk"], ids["pad"]
        self.mask_token = mask_token
        # longest first, so that no special token is split by a shorter one
        self._specials = sorted(specials.values(), key=len, reverse=True)
        self._cache: dict[str, list[int]] = {}

    @classmethod
    def from_dir(cls, path: str) -> "ByteLevelBPE":
        """vocab.json, merges.txt and (when present) tokenizer_config.json's
        special tokens of a local HF RoBERTa directory."""
        path = pathlib.Path(path)
        for name in ("vocab.json", "merges.txt"):
            if not (path / name).exists():
                raise FileNotFoundError(
                    f"{path / name} not found: the port's byte-level BPE "
                    "reads a local vocab.json and merges.txt")
        vocab = json.loads((path / "vocab.json").read_text(encoding="utf-8"))
        merges = []
        for line in (path / "merges.txt").read_text(encoding="utf-8").split("\n"):
            if line.startswith("#version") or not line.strip():
                continue
            a, b = line.split(" ")
            merges.append((a, b))
        cfg = {}
        if (path / "tokenizer_config.json").exists():
            cfg = json.loads((path / "tokenizer_config.json").read_text())
        if cfg.get("add_prefix_space", False):
            raise ValueError(f"{path}: add_prefix_space=True is not "
                             "RobertaTokenizerFast's default, which this "
                             "tokenizer follows")
        names = special_tokens(cfg, ("bos_token", "eos_token", "unk_token",
                                     "pad_token", "mask_token"))
        return cls(vocab, merges, **names)

    def _bpe(self, word: str) -> list[int]:
        """The ids of one pre-tokenized word: its bytes as table characters,
        the pair of lowest rank merged everywhere, left to right, until no
        pair has a rank (GPT-2's loop)."""
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        parts = [self.byte_char[b] for b in word.encode("utf-8")]
        while len(parts) > 1:
            ranked = [(self.ranks[p], p) for p in zip(parts, parts[1:])
                      if p in self.ranks]
            if not ranked:
                break
            first, second = min(ranked)[1]
            merged, i = [], 0
            while i < len(parts):
                if (i + 1 < len(parts) and parts[i] == first
                        and parts[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        ids = [self.vocab.get(p, self.unk_token_id) for p in parts]
        self._cache[word] = ids
        return ids

    def _split_specials(self, text: str) -> list[tuple[str, bool]]:
        """(segment, is_special) in order; <mask> strips the white space
        before it."""
        segs = [(text, False)]
        for tok in self._specials:
            nxt = []
            for seg, special in segs:
                if special or tok not in seg:
                    nxt.append((seg, special))
                    continue
                pieces = seg.split(tok)
                for j, piece in enumerate(pieces):
                    if j < len(pieces) - 1 and tok == self.mask_token:
                        piece = piece.rstrip("".join(WHITE_SPACE))
                    if piece:
                        nxt.append((piece, False))
                    if j < len(pieces) - 1:
                        nxt.append((tok, True))
            segs = nxt
        return segs

    def encode(self, text: str) -> np.ndarray:
        """Ids of text, no special tokens added (literal ones pass through)."""
        ids: list[int] = []
        for seg, special in self._split_specials(text):
            if special:
                ids.append(self.vocab[seg])
                continue
            for word in pre_tokenize(seg):
                ids.extend(self._bpe(word))
        return np.asarray(ids, np.int32)

    def build_inputs_with_special_tokens(self, token_ids_0: list[int]) -> list[int]:
        """<s> ids </s>, as RobertaTokenizerFast builds a single sequence."""
        return [self.cls_token_id] + list(token_ids_0) + [self.sep_token_id]

