"""ctypes bindings for the native WordPiece tokenizer (the port's own copy of
aspire_tpu/text/fast.py over native/aspire_text.cpp).

The library is built with g++ at first use from the sources in
``aspire_tpu_torch/native/`` into ``build/aspire_tpu_torch/`` beside the
package, named after a hash of those sources and the flags, and written under
a temporary name first so that processes building it at once never load a
half-written file.  Nothing is ever written into ``native/``.

`FastWordPiece` is the port's WordPiece tokenizer (BERT's and MPNet's):
BERT's BasicTokenizer + WordPiece, with the ids of Hugging Face's
``BertTokenizer`` (exact on ASCII; the generated unicode tables carry the
rest).  RoBERTa's byte-level BPE is text/bpe.py.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import pathlib
import re
import subprocess

import numpy as np

from .tokenize import TokenizedDoc, MAX_NUM_TOKS

NATIVE_DIR = pathlib.Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "aspire_tpu_torch"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lib = None


def _digest() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for p in sorted(NATIVE_DIR.glob("*.[ch]*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(build_dir: pathlib.Path | None = None) -> pathlib.Path:
    """Where the library for the current sources lives (built or not)."""
    return (build_dir or BUILD_DIR) / f"libaspire_text_{_digest()}.so"


def build(build_dir: pathlib.Path | None = None) -> pathlib.Path:
    """Build the library unless it is there already; returns its path."""
    target = library_path(build_dir)
    if target.exists():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(NATIVE_DIR / "aspire_text.cpp"), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("native tokenizer build failed:\n" + " ".join(cmd)
                           + "\n" + proc.stderr)
    os.replace(tmp, target)
    return target


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.at_load_vocab.restype = ctypes.c_void_p
    lib.at_load_vocab.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.at_free_vocab.argtypes = [ctypes.c_void_p]
    lib.at_vocab_size.restype = ctypes.c_int32
    lib.at_vocab_size.argtypes = [ctypes.c_void_p]
    lib.at_token_id.restype = ctypes.c_int32
    lib.at_token_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.at_tokenize.restype = ctypes.c_int32
    lib.at_tokenize.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_int32, i32p, ctypes.c_int32]
    lib.at_pack_doc.restype = ctypes.c_int32
    lib.at_pack_doc.argtypes = [i32p, i32p, ctypes.c_int32, ctypes.c_int32,
                                ctypes.c_int32, ctypes.c_int32, i32p, i32p,
                                np.ctypeslib.ndpointer(np.int32)]
    _lib = lib
    return lib


def special_tokens(cfg: dict, keys) -> dict:
    """The special tokens a tokenizer_config.json names: a string, or (newer
    files) an AddedToken dict whose ``content`` is the string."""
    out = {}
    for k in keys:
        v = cfg.get(k)
        if isinstance(v, dict):
            v = v.get("content")
        if isinstance(v, str):
            out[k] = v
    return out


class FastWordPiece:
    """Native BERT tokenizer: BasicTokenizer + WordPiece, ids as HF's.

    vocab_file: one token per line (standard BERT vocab.txt).
    `pad_token_id` is the vocab's own [PAD] (the unknown token's id when the
    vocab has none, as HF gives it).
    """

    def __init__(self, vocab_file: str, lowercase: bool = True,
                 unk_token: str = "[UNK]", cls_token: str = "[CLS]",
                 sep_token: str = "[SEP]", pad_token: str = "[PAD]",
                 mask_token: str = "[MASK]"):
        lib = _load()
        self._lib = lib
        self._vocab = lib.at_load_vocab(str(vocab_file).encode(),
                                        unk_token.encode())
        if not self._vocab:
            raise RuntimeError(f"could not load vocab {vocab_file}")
        self.unk_token_id = lib.at_token_id(self._vocab, unk_token.encode())
        self.lowercase = lowercase
        self.vocab_size = lib.at_vocab_size(self._vocab)
        self.cls_token_id = lib.at_token_id(self._vocab, cls_token.encode())
        self.sep_token_id = lib.at_token_id(self._vocab, sep_token.encode())
        pad = lib.at_token_id(self._vocab, pad_token.encode())
        self.pad_token_id = pad if pad >= 0 else self.unk_token_id
        # HF splits out special tokens before basic tokenization; mirror that.
        self._specials = {
            t: lib.at_token_id(self._vocab, t.encode())
            for t in (unk_token, cls_token, sep_token, pad_token, mask_token)
            if lib.at_token_id(self._vocab, t.encode()) >= 0
        }
        self._special_re = re.compile(
            "(" + "|".join(re.escape(t) for t in self._specials) + ")")
        # id -> token strings for the HF-compatible tokenize()/convert APIs
        # (the entity-span matcher compares token-string sublists)
        with open(vocab_file, encoding="utf-8") as f:
            self._id2tok = [ln.rstrip("\n") for ln in f]

    @classmethod
    def from_dir(cls, path: str) -> "FastWordPiece":
        """The tokenizer of a local HF model directory: its vocab.txt, and
        do_lower_case and the special tokens from tokenizer_config.json
        when that file exists (HF's BertTokenizer lowercases by default).
        MPNet's config names <s> </s> <pad> <mask>; a special token the
        config names and the vocab lacks raises."""
        path = pathlib.Path(path)
        vocab = path / "vocab.txt"
        if not vocab.exists():
            raise FileNotFoundError(
                f"{vocab} not found: the port's tokenizer reads a local BERT "
                "vocab.txt (hub names cannot be downloaded here)")
        cfg = {}
        if (path / "tokenizer_config.json").exists():
            with open(path / "tokenizer_config.json") as f:
                cfg = json.load(f)
        lowercase = bool(cfg.get("do_lower_case", True))
        if cfg.get("strip_accents") not in (None, lowercase) \
                or cfg.get("tokenize_chinese_chars", True) is not True:
            raise ValueError(
                f"{path}: strip_accents={cfg.get('strip_accents')!r} / "
                f"tokenize_chinese_chars={cfg.get('tokenize_chinese_chars')!r} "
                "are not BERT's defaults, which the native tokenizer follows")
        names = special_tokens(cfg, ("unk_token", "cls_token", "sep_token",
                                     "pad_token", "mask_token"))
        with open(vocab, encoding="utf-8") as f:
            known = {ln.rstrip("\n") for ln in f}
        missing = {k: v for k, v in names.items() if v not in known}
        if missing:
            raise ValueError(f"{path}: tokenizer_config.json names special "
                             f"tokens that {vocab.name} lacks: {missing}")
        return cls(str(vocab), lowercase=lowercase, **names)

    def __del__(self):
        if getattr(self, "_vocab", None):
            self._lib.at_free_vocab(self._vocab)
            self._vocab = None

    def encode(self, text: str, max_out: int = 8192) -> np.ndarray:
        """WordPiece ids for text (literal special tokens pass through)."""
        pieces: list[np.ndarray] = []
        for seg in self._special_re.split(text):
            if not seg:
                continue
            if seg in self._specials:
                pieces.append(np.asarray([self._specials[seg]], np.int32))
            else:
                out = np.empty(max_out, np.int32)
                n = self._lib.at_tokenize(self._vocab, seg.encode(),
                                          int(self.lowercase), out, max_out)
                pieces.append(out[:n].copy())
        if not pieces:
            return np.empty(0, np.int32)
        return np.concatenate(pieces)

    def tokenize(self, text: str) -> list[str]:
        """Token strings (HF BertTokenizer.tokenize drop-in): the entity-span
        matcher (text.tokenize.ner_token_spans) compares string sublists."""
        return [self._id2tok[i] for i in self.encode(text)]

    def convert_tokens_to_ids(self, tokens: list[str]) -> list[int]:
        ids = (self._lib.at_token_id(self._vocab, t.encode()) for t in tokens)
        return [i if i >= 0 else self.unk_token_id for i in ids]

    def build_inputs_with_special_tokens(self, token_ids_0: list[int]) -> list[int]:
        """[CLS] ids [SEP], as HF's BertTokenizer builds a single sequence."""
        return [self.cls_token_id] + list(token_ids_0) + [self.sep_token_id]

    def tokenize_doc_sents(self, doc_sents: list[str],
                           max_num_toks: int = MAX_NUM_TOKS) -> TokenizedDoc:
        """Native equivalent of text.tokenize.tokenize_doc_sents: title-first
        sentence list -> token ids + per-sentence index lists."""
        per_sent = [self.encode(s) for s in doc_sents]
        counts = np.asarray([len(x) for x in per_sent], np.int32)
        flat = (np.concatenate(per_sent) if per_sent else
                np.empty(0, np.int32)).astype(np.int32)
        cap = int(counts.sum()) + 2
        out_tokens = np.empty(cap, np.int32)
        out_labels = np.empty(cap, np.int32)
        n_sents = np.empty(1, np.int32)
        n = self._lib.at_pack_doc(flat, counts, len(counts), max_num_toks,
                                  self.cls_token_id, self.sep_token_id,
                                  out_tokens, out_labels, n_sents)
        token_ids = out_tokens[:n].tolist()
        labels = out_labels[:n]
        sent_token_idxs = [np.nonzero(labels == s)[0].tolist()
                          for s in range(int(n_sents[0]))]
        return TokenizedDoc(token_ids=token_ids, sent_token_idxs=sent_token_idxs)
