"""The port's trained sentence aligner (data/align.py) against the JAX
package's on the same cosentbert weights: a BERT of 2 layers, hidden 64,
initialised by the JAX package with numpy noise on every weight, saved as
the JAX package's orbax run and carried to the port's run directory by
models/convert.py.  The port encodes on the CPU (device="cpu").

  * embeddings (unit rows) within 1e-5 of the JAX package's;
  * generate_examples_cocitabs through each package's aligner: the same
    alignments, hence the same files, on distinct sentences;
  * the --extra plumbing (_extra_aligner) and the CUDA default."""
import json

import jax
import numpy as np
import pytest
import torch

from aspire_tpu.core.config import RunConfig as JRunConfig
from aspire_tpu.data import align as jalign
from aspire_tpu.data import preprocess as jpp
from aspire_tpu.models.bert import BertConfig as JConfig
from aspire_tpu.models.bert import BertModel as JBert
from aspire_tpu_torch.core.config import RunConfig
from aspire_tpu_torch.data import align as talign
from aspire_tpu_torch.data import preprocess as tpp
from aspire_tpu_torch.models.convert import state_dict_from_flax_params

TOL = 1e-5
WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta",
         "iota", "kappa", "lambda", "mu", "nu", "xi", "omicron", "pi"]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ".", "[", "]"] + WORDS


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sentence(rng) -> str:
    words = list(rng.choice(WORDS, int(rng.integers(3, 12))))
    return " ".join([words[0].capitalize()] + words[1:]) + "."


def distinct_sentences(rng, n: int) -> list:
    out = {}
    while len(out) < n:
        out[sentence(rng)] = None
    return list(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(vocab dir, JAX run dir, port run dir) of one cosentbert."""
    import orbax.checkpoint as ocp
    root = tmp_path_factory.mktemp("align")
    (root / "vocab").mkdir()
    (root / "vocab" / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    (root / "vocab" / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "BertTokenizer", "do_lower_case": True}))
    cfg = JConfig.tiny(vocab_size=len(VOCAB), hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=128)
    zeros = (np.zeros((1, 8), np.int32),) * 2
    tree = JBert(cfg).init(jax.random.key(3), *zeros)["params"]
    rng = np.random.default_rng(4)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32) + 0.05 * rng.standard_normal(
        x.shape).astype(np.float32), tree)
    hp = {"model_name": "cosentbert", "score_aggregation": "l2max"}
    jrun, trun = root / "jax_run", root / "port_run"
    jrun.mkdir()
    rc = JRunConfig.from_dict(hp)
    rc.extra["bert_config"] = dict(vars(cfg))
    rc.to_run_info(jrun / "run_info.json")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save((jrun / "model_cur_best").absolute(), tree, force=True)
    ckptr.wait_until_finished()
    trun.mkdir()
    rc = RunConfig.from_dict(hp)
    rc.extra["bert_config"] = dict(vars(cfg))
    rc.to_run_info(trun / "run_info.json")
    torch.save(state_dict_from_flax_params(tree, prefix="encoder."),
               trun / "model_cur_best.pt")
    return str(root / "vocab"), str(jrun), str(trun)


@pytest.fixture(scope="module")
def aligners(runs):
    vocab, jrun, trun = runs
    return (talign.trained_sent_aligner(trun, vocab, device="cpu"),
            jalign.trained_sent_aligner(jrun, vocab))


@pytest.mark.parametrize("n", [1, 7, 40])
def test_embeddings_match_jax(aligners, n):
    port, jax_ = aligners
    sents = distinct_sentences(np.random.default_rng(10 + n), n)
    got, want = port(sents), np.asarray(jax_(sents))
    assert got.dtype == np.float32 and got.shape == (n, 64)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_aligned_examples_equal(aligners, tmp_path):
    """Co-cited abstracts of distinct sentences aligned by each package's
    aligner: equal files (cc_align, abs_align and every other field)."""
    port, jax_ = aligners
    rng = np.random.default_rng(21)
    sents = iter(distinct_sentences(rng, 200))
    pids = [f"p{i}" for i in range(16)]
    pid2abstract = {p: {"title": f"title {p}",
                        "abstract": [next(sents) for _ in range(int(rng.integers(3, 6)))]}
                    for p in pids}
    cocits = {}
    for k in range(10):
        group = tuple(sorted(rng.choice(pids, int(rng.integers(2, 4)), replace=False)))
        cocits[group] = [(f"c{k}_{j}", "we cite [1] " + next(sents))
                         for j in range(int(rng.integers(2, 4)))]
    got = tpp.generate_examples_cocitabs(cocits, pid2abstract, str(tmp_path / "t"),
                                         train_size=100, dev_size=100, aligner=port)
    want = jpp.generate_examples_cocitabs(cocits, pid2abstract, str(tmp_path / "j"),
                                          train_size=100, dev_size=100, aligner=jax_)
    assert got == want and got["train"] > 0
    for name in ("train-cocitabsalign.jsonl", "dev-cocitabsalign.jsonl"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()


def test_extra_aligner_and_device(runs):
    vocab, _, trun = runs
    extra = {"aligner_run_dir": trun, "aligner_tokenizer": vocab,
             "aligner_model": "cosentbert", "train_size": 5}
    aligner = tpp._extra_aligner(extra, device="cpu")
    assert extra == {"train_size": 5}                  # the aligner keys popped
    assert aligner.model.bert.embeddings.word_embeddings.weight.device.type == "cpu"
    assert tpp._extra_aligner({"train_size": 5}) is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            talign.trained_sent_aligner(trun, vocab)   # the default is "cuda"
