"""Training-data readers (data/readers.py): the port's TripleStream and
dev_batches against the JAX package's on the same jsonl files -- ids,
sentence ids, masks, lengths, alignments and shapes equal, with and without
length buckets and with the seeded buffer shuffle over two epochs.  The port
reads through its own FastWordPiece, the JAX package through HF's
BertTokenizer (the same ids on ASCII text)."""
import json

import numpy as np
import pytest
import torch
from transformers import BertTokenizer

from aspire_tpu.core.config import ModelHParams as JHParams
from aspire_tpu.data import readers as jreaders
from aspire_tpu_torch.core.config import ModelHParams
from aspire_tpu_torch.data import readers as treaders
from aspire_tpu_torch.text.fast import FastWordPiece

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta",
         "optimal", "transport", "##s", "model"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test workers share the machine's cores: torch's intra-op pool at its
    default size oversubscribes them, and this file's many small ops then
    run tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "title", ".", ","] + WORDS
    p = tmp_path_factory.mktemp("rv") / "vocab.txt"
    p.write_text("\n".join(vocab) + "\n")
    return str(p)


@pytest.fixture(scope="module")
def toks(vocab_file):
    return FastWordPiece(vocab_file), BertTokenizer(vocab_file, do_lower_case=True)


def _sent(rng, lo=2, hi=12):
    words = [w for w in WORDS if not w.startswith("##")]
    return " ".join(rng.choice(words, int(rng.integers(lo, hi)))) + "."


def write_triples(path, rng, n, neg=False):
    """Abstract dicts with cc_align, and now and then a raw sentence string
    as the query (the sentence-model files' layout, readers._as_doc)."""
    def doc(raw_ok=False):
        if raw_ok and rng.random() < 0.15:
            return _sent(rng)
        n_s = int(rng.integers(1, 7))
        return {"TITLE": "Title " + _sent(rng, 1, 4),
                "ABSTRACT": [_sent(rng) for _ in range(n_s)],
                "cc_align": [int(rng.integers(0, n_s)), int(rng.integers(0, 3))]}
    with open(path, "w") as f:
        for _ in range(n):
            ex = {"query": doc(raw_ok=True), "pos_context": doc()}
            if neg:
                ex["neg_context"] = doc()
            f.write(json.dumps(ex) + "\n")


def assert_tree_equal(got, want, path=""):
    assert type(got) is type(want) or isinstance(got, dict) == isinstance(want, dict)
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (path, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=path)


def test_read_jsonl_and_as_doc(tmp_path, rng):
    write_triples(tmp_path / "t.jsonl", rng, 6)
    got = list(treaders.read_jsonl(str(tmp_path / "t.jsonl")))
    assert got == list(jreaders.read_jsonl(str(tmp_path / "t.jsonl")))
    for ex in got:
        assert treaders._as_doc(ex["query"]) == jreaders._as_doc(ex["query"])


@pytest.mark.parametrize("seq_buckets", [None, (32, 48, 64)])
@pytest.mark.parametrize("shuffle_seed", [None, 3])
def test_triple_stream_matches(tmp_path, rng, toks, seq_buckets, shuffle_seed):
    fast, hf = toks
    write_triples(tmp_path / "train.jsonl", rng, 41)
    kw = dict(micro_batch=3, n_micro=2, seq_len=64, align_type="cc_align",
              max_examples=39, shuffle_seed=shuffle_seed, shuffle_buffer=7,
              seq_buckets=seq_buckets)
    port = treaders.TripleStream(str(tmp_path / "train.jsonl"), fast,
                                 ModelHParams(max_sents=4), **kw)
    jax_ = jreaders.TripleStream(str(tmp_path / "train.jsonl"), hf,
                                 JHParams(max_sents=4), **kw)
    for epoch in range(2):        # the shuffle's seed moves with the epoch
        got, want = list(port), list(jax_)
        assert len(got) == len(want) >= 2, (len(got), len(want))
        for g, w in zip(got, want):
            assert_tree_equal(g, w)
            assert g["query"]["token_ids"].shape[:2] == (2, 3)
            assert g["pos"]["align"].shape == (2, 3, 2)
    if seq_buckets:
        lens = {g["query"]["token_ids"].shape[2] for g in got}
        assert lens <= set(seq_buckets)


def test_dev_batches_match(tmp_path, rng, toks):
    fast, hf = toks
    write_triples(tmp_path / "dev.jsonl", rng, 11, neg=True)
    got = list(treaders.dev_batches(str(tmp_path / "dev.jsonl"), fast,
                                    ModelHParams(max_sents=5), batch_size=4,
                                    seq_len=48, align_type="cc_align",
                                    max_examples=10))
    want = list(jreaders.dev_batches(str(tmp_path / "dev.jsonl"), hf,
                                     JHParams(max_sents=5), batch_size=4,
                                     seq_len=48, align_type="cc_align",
                                     max_examples=10))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == {"query", "pos", "neg"}
        assert_tree_equal(g, w)


def test_superbatches_feed_the_port_trainer(tmp_path, rng, vocab_file):
    """A TripleStream superbatch is the layout Trainer.train takes: one
    optimizer step of a tiny model on the CPU."""
    from aspire_tpu_torch.core.config import RunConfig
    from aspire_tpu_torch.models.bert import BertConfig
    from aspire_tpu_torch.models.doc_models import build_model
    from aspire_tpu_torch.train.trainer import Trainer

    write_triples(tmp_path / "train.jsonl", rng, 6)
    rc = RunConfig.from_dict({"model_name": "miswordbienc", "max_sents": 4,
                              "batch_size": 3, "accumulated_batch_size": 6,
                              "num_warmup_steps": 1, "learning_rate": 1e-3})
    fast = FastWordPiece(vocab_file)
    torch.manual_seed(0)
    model = build_model(rc.model, BertConfig.tiny(vocab_size=fast.vocab_size),
                        device="cpu")
    stream = treaders.TripleStream(str(tmp_path / "train.jsonl"), fast,
                                   rc.model, micro_batch=3, n_micro=2, seq_len=64)
    trainer = Trainer(model, rc, str(tmp_path / "run"), fused_accum=True)
    state = trainer.train(trainer.init_state(), stream, None, seed=0)
    assert state.step == 1
    assert all(np.isfinite(trainer.loss_history))
