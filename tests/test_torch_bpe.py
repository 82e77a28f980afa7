"""The port's byte-level BPE (text/bpe.py) against Hugging Face's
``RobertaTokenizerFast`` on the same vocab.json + merges.txt (trained here by
`tokenizers` on a small corpus): ids equal on fixed text -- scientific
abstracts, digits, runs of spaces, contractions, accents, CJK, emoji, special
tokens -- and under a hypothesis fuzz over BMP text; the hand-written
pre-tokenizer equal to GPT-2's pattern run by the `regex` package."""
import json
import unicodedata

import pytest
import regex
from hypothesis import given, settings, strategies as st
from tokenizers import ByteLevelBPETokenizer
from transformers import RobertaTokenizerFast

from aspire_tpu_torch.text.bpe import ByteLevelBPE, bytes_to_unicode, pre_tokenize

SPECIALS = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]
CORPUS = [
    "We present a new scientific document similarity model based on matching "
    "fine-grained aspects of texts.",
    "Our model is trained using co-citation contexts as textual supervision; "
    "it's 2.5x faster and we'll release 1,024 models.",
    "Café naïve résumé Ångström façade — über Straße.",
    "一二三 日本語のテキスト 中文 한국어 😀🚀 ½ ² ٣ ०१२",
    "Don't they've I'm she'd you're OK?!... (x+y)=z; 3.14159 e^{i\\pi}",
    "   leading spaces\ttabs\n\nnew lines   no-break thin",
] * 5
TEXTS = [
    "Matching is computed over contextual sentence embeddings.",
    "We introduce a test collection for faceted query by example retrieval "
    "(CSFCube), with 50 queries and 3 facets.",
    "It's the model's 12th layer; they'll've seen it, I'D say 'quoted'.",
    "a  b   c    d\n\n\ne\t\tf \n g",
    " leading", "trailing ", "   ", "", " ", "\n", "1234567890 3.14 -2e10 1,000",
    "Café naïve résumé Ångström façade über", "一二三四五 中文文本 日本語",
    "emoji 😀🚀👍🏽 flags 🇩🇪", "x\u001cy\u001fz", " line para　ideo",
    "<s>hello</s> world<pad> a <mask> b <unk>", "tab\t<mask>x",
]


@pytest.fixture(scope="module")
def tokenizers_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("bpe")
    trainer = ByteLevelBPETokenizer()
    trainer.train_from_iterator(CORPUS, vocab_size=700, min_frequency=1,
                                special_tokens=SPECIALS)
    trainer.save_model(str(d))
    hf = RobertaTokenizerFast(str(d / "vocab.json"), str(d / "merges.txt"))
    hf.save_pretrained(str(d))
    return d, hf


@pytest.fixture(scope="module")
def port(tokenizers_dir):
    return ByteLevelBPE.from_dir(str(tokenizers_dir[0]))


GPT2_PATTERN = regex.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")


@pytest.mark.parametrize("text", TEXTS + CORPUS[:6])
def test_ids_equal_huggingface(tokenizers_dir, port, text):
    hf = tokenizers_dir[1]
    assert port.encode(text).tolist() == hf(text, add_special_tokens=False)["input_ids"]


def test_special_tokens_and_single_sequence(tokenizers_dir, port):
    hf = tokenizers_dir[1]
    assert port.pad_token_id == hf.pad_token_id == 1
    ids = port.encode(TEXTS[0]).tolist()
    assert port.build_inputs_with_special_tokens(ids) == hf(TEXTS[0])["input_ids"]
    assert (port.cls_token_id, port.sep_token_id) == (hf.cls_token_id,
                                                      hf.sep_token_id)


def test_byte_table_is_gpt2s():
    table = bytes_to_unicode()
    assert len(set(table.values())) == 256
    assert table[ord("A")] == "A" and table[ord(" ")] == "\u0120"
    assert table[ord("\n")] == "\u010a"


BMP = st.characters(max_codepoint=0xFFFF, exclude_categories=("Cs",))
# text with more of the pattern's edge cases than uniform code points give
EDGY = st.lists(st.one_of(BMP, st.sampled_from([" ", "  ", "'s", "'ll", "'", "\n",
                                                "\t", "1", "a", "é", "一", "."])),
                max_size=30).map("".join)


@settings(max_examples=300, deadline=None)
@given(text=st.one_of(st.text(BMP, max_size=40), EDGY))
def test_fuzz_ids_equal_huggingface(tokenizers_dir, port, text):
    hf = tokenizers_dir[1]
    assert port.encode(text).tolist() == hf(text, add_special_tokens=False)["input_ids"]


# code points this Python's Unicode assigns: the `regex` package carries a
# newer Unicode, where a few more are letters
ASSIGNED = st.characters(max_codepoint=0xFFFF, exclude_categories=("Cs", "Cn"))


@settings(max_examples=300, deadline=None)
@given(text=st.one_of(st.text(ASSIGNED, max_size=40), EDGY.filter(
    lambda t: all(unicodedata.category(c) != "Cn" for c in t))))
def test_fuzz_pre_tokenizer_equals_the_pattern(text):
    assert pre_tokenize(text) == GPT2_PATTERN.findall(text)


def test_add_prefix_space_is_refused(tokenizers_dir, tmp_path):
    d = tokenizers_dir[0]
    for name in ("vocab.json", "merges.txt"):
        (tmp_path / name).write_bytes((d / name).read_bytes())
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(
        {"add_prefix_space": True}))
    with pytest.raises(ValueError, match="add_prefix_space"):
        ByteLevelBPE.from_dir(str(tmp_path))
