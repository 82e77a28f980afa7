"""The port's native WordPiece tokenizer (text/fast.py + native/): ids equal
to HF's BertTokenizer and to the JAX package's FastWordPiece on ASCII text,
the unicode cases and a seeded fuzz; document packing equal; the library
built under build/ from the port's own sources, never into native/."""
import hashlib
import json
import pathlib

import numpy as np
import pytest
from transformers import BertTokenizer

from aspire_tpu.text.fast import FastWordPiece as JFast
from aspire_tpu.text.tokenize import tokenize_doc_sents as j_tokenize_doc_sents
from aspire_tpu_torch.text import fast as tfast
from aspire_tpu_torch.text.fast import FastWordPiece
from aspire_tpu_torch.text.tokenize import prepare_abstracts

REPO = pathlib.Path(__file__).resolve().parent.parent

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
         "the", "model", "we", "propose", "a", "new", "method", "for",
         "document", "similarity", "using", "optimal", "transport",
         "em", "##bed", "##ding", "##s", "and", "sentence", "-", "level",
         "(", ")", "[", "]", "1", "2", "99", ".", ",", "su", "##per",
         "##vision", "co", "##cit", "##ation", "title",
         "λογος", "λ", "##ο", "##γ", "##ος", "##ς", "σ", "α", "β", "##β",
         "resume", "uber", "##ber", "数", "学", "ω"]

SENTS = [
    "We propose a new method for document similarity.",
    "Using optimal transport embeddings, and sentence-level supervision (1).",
    "The model [2] and cocitation supervision.",
    "UNKNOWNWORD99 stays unknown, (surely).",
    "punctuation...everywhere, [1] (2) [99].",
    "[CLS] the [MASK] model [SEP] [PAD]",
]

UNICODE_SENTS = [
    "ΛΌΓΟΣ και ΣΟΦΙΑ",
    "the λόγος appears σ and Σ.",
    "his RÉSUMÉ and Über model",
    "naïve café, coöperate",
    "we study 数学 here",
    "“quoted” text — with • bullets…",
    "non breaking zero​width so­ft",
    "á combining ë marks",
    "ΣΣ Σ, Σb",
]


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("fv")
    (d / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    return d


@pytest.fixture(scope="module")
def toks(vocab_dir):
    f = str(vocab_dir / "vocab.txt")
    return (FastWordPiece(f), BertTokenizer(f, do_lower_case=True), JFast(f))


def _hf_ids(hf, text):
    return hf.convert_tokens_to_ids(hf.tokenize(text))


@pytest.mark.parametrize("text", SENTS + UNICODE_SENTS)
def test_ids_equal_hf_and_jax(toks, text):
    port, hf, jfast = toks
    got = port.encode(text).tolist()
    assert got == _hf_ids(hf, text), (text, hf.tokenize(text), got)
    assert got == jfast.encode(text).tolist()
    assert port.tokenize(text) == hf.tokenize(text)


def test_fuzz_equal_hf(toks, rng):
    port, hf, jfast = toks
    alphabet = list("aB .,()-") + ["é", "Σ", "σ", "ς", "ά", "Ω", "ß", "“", "—",
                                   " ", "中", "数", "λ", "Ό", "ö", "​",
                                   "́", "9", "[", "²", "µ", "Å", "\t"]
    words = ["the", "model", "embeddings", "supervision", "cocitation", "99"]
    for _ in range(300):
        parts = [rng.choice(alphabet) if rng.random() < 0.7 else
                 " " + str(rng.choice(words)) + " "
                 for _ in range(int(rng.integers(1, 24)))]
        s = "".join(parts)
        got = port.encode(s).tolist()
        assert got == _hf_ids(hf, s), (repr(s), hf.tokenize(s), got)
        assert got == jfast.encode(s).tolist()


def test_hf_api_members(toks):
    port, hf, _ = toks
    toks_ = hf.tokenize(SENTS[1])
    assert port.convert_tokens_to_ids(toks_ + ["nope"]) == \
        hf.convert_tokens_to_ids(toks_ + ["nope"])
    ids = _hf_ids(hf, SENTS[0])
    assert port.build_inputs_with_special_tokens(ids) == \
        hf.build_inputs_with_special_tokens(ids)
    assert (port.pad_token_id, port.cls_token_id, port.sep_token_id,
            port.unk_token_id, port.vocab_size) == \
        (hf.pad_token_id, hf.cls_token_id, hf.sep_token_id, hf.unk_token_id,
         hf.vocab_size)


def test_doc_packing_equal(toks):
    port, hf, jfast = toks
    doc = ["title [SEP] "] + SENTS[:3]
    for cap in (500, 12, 7):
        ref = j_tokenize_doc_sents(doc, hf, max_num_toks=cap)
        for got in (port.tokenize_doc_sents(doc, max_num_toks=cap),
                    jfast.tokenize_doc_sents(doc, max_num_toks=cap)):
            assert got.token_ids == ref.token_ids
            assert got.sent_token_idxs == ref.sent_token_idxs
    papers = [{"TITLE": "Title", "ABSTRACT": SENTS[:4]},
              {"TITLE": "the λόγος", "ABSTRACT": UNICODE_SENTS[:3]}]
    fb_port = prepare_abstracts(papers, port, max_sents=3, seq_len=64)
    from aspire_tpu.text.tokenize import prepare_abstracts as j_prepare
    fb_hf = j_prepare(papers, hf, max_sents=3, seq_len=64)
    for name in ("token_ids", "attn_mask", "sent_ids", "abs_lens"):
        np.testing.assert_array_equal(getattr(fb_port, name),
                                      getattr(fb_hf, name), err_msg=name)


def test_from_dir_reads_tokenizer_config(tmp_path):
    (tmp_path / "vocab.txt").write_text(
        "\n".join(["[UNK]", "[CLS]", "[SEP]", "[MASK]", "Hello", "hello",
                   "world"]) + "\n")
    lower = FastWordPiece.from_dir(str(tmp_path))
    assert lower.lowercase and lower.encode("Hello world").tolist() == [5, 6]
    # no [PAD] in the vocab: HF gives the unknown token's id
    assert lower.pad_token_id == lower.unk_token_id == 0
    (tmp_path / "tokenizer_config.json").write_text(
        json.dumps({"do_lower_case": False}))
    cased = FastWordPiece.from_dir(str(tmp_path))
    hf = BertTokenizer(str(tmp_path / "vocab.txt"), do_lower_case=False)
    assert cased.encode("Hello world").tolist() == [4, 6] == \
        _hf_ids(hf, "Hello world")
    (tmp_path / "tokenizer_config.json").write_text(
        json.dumps({"do_lower_case": True, "strip_accents": False}))
    with pytest.raises(ValueError, match="strip_accents"):
        FastWordPiece.from_dir(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="vocab.txt"):
        FastWordPiece.from_dir(str(tmp_path / "nowhere"))


def _fingerprint(path: pathlib.Path):
    return hashlib.sha256(path.read_bytes()).hexdigest(), path.stat().st_mtime_ns


def test_library_builds_under_build_never_into_native(tmp_path, monkeypatch):
    jax_lib = REPO / "native" / "libaspire_text.so"
    before = _fingerprint(jax_lib) if jax_lib.exists() else None
    native_before = sorted(p.name for p in tfast.NATIVE_DIR.iterdir())
    built = tfast.build(tmp_path / "build")
    assert built.parent == tmp_path / "build" and built.exists()
    assert built.name == tfast.library_path(tmp_path / "build").name
    assert built.name.startswith("libaspire_text_") and built.suffix == ".so"
    assert not list((tmp_path / "build").glob("*.tmp"))
    # the second call finds it and builds nothing
    mtime = built.stat().st_mtime_ns
    assert tfast.build(tmp_path / "build") == built
    assert built.stat().st_mtime_ns == mtime
    # the default place is build/aspire_tpu_torch/ beside the package
    assert tfast.BUILD_DIR == REPO / "build" / "aspire_tpu_torch"
    assert tfast.NATIVE_DIR == REPO / "aspire_tpu_torch" / "native"
    assert sorted(p.name for p in tfast.NATIVE_DIR.iterdir()) == native_before
    assert {"aspire_text.cpp", "aspire_unicode_tables.h",
            "gen_unicode_tables.py"} <= set(native_before)
    assert not any(n.endswith(".so") for n in native_before)
    if before is not None:
        assert _fingerprint(jax_lib) == before


def test_native_sources_are_the_jax_packages(tmp_path):
    """The unicode tables are the JAX package's (the port regenerates them
    with its own copy of the generator)."""
    for name in ("aspire_unicode_tables.h",):
        assert (tfast.NATIVE_DIR / name).read_bytes() == \
            (REPO / "native" / name).read_bytes()
    import subprocess
    import sys
    out = subprocess.run([sys.executable,
                          str(tfast.NATIVE_DIR / "gen_unicode_tables.py")],
                         capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout == (tfast.NATIVE_DIR / "aspire_unicode_tables.h").read_text()
