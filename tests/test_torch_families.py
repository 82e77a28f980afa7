"""The sentence-transformer baselines of other families: RoBERTa
(`sbrobertanli`, byte-level BPE) and MPNet (`sbmpnet1B`, WordPiece with
<s> </s> <pad> <mask>, relative position bias), read by
models/convert.load_hf_dir without `transformers`.

Random tiny directories (2 layers, hidden 32, weights from a numpy seed) are
written here by `transformers`; the port's encoders equal Hugging Face's
modules, and the port's `SbertSimilarityModel(..., device="cpu")` equals the
JAX package's (which runs these families through `transformers` on the CPU)
within 1e-4 across batch compositions, in `get_similarities` and in a whole
`evaluate` run."""
import json

import numpy as np
import pytest
import torch
import transformers
from tokenizers import ByteLevelBPETokenizer

from aspire_tpu.evaluation.datasets import EvalDataset as JDataset
from aspire_tpu.evaluation.evaluate import run_evaluation as j_run_evaluation
from aspire_tpu.evaluation.models import SbertSimilarityModel as JSbert
from aspire_tpu_torch import cli
from aspire_tpu_torch.evaluation.models import SbertSimilarityModel, get_model
from aspire_tpu_torch.models.bert import position_ids_past_padding
from aspire_tpu_torch.models.convert import load_hf_dir
from aspire_tpu_torch.models.mpnet import relative_position_bucket
from aspire_tpu_torch.text.fast import FastWordPiece
from tests_evalds import make_eval_dataset

TOL = 1e-4
WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta",
         "model", "matching", "aspect", "sentence", "similarity", "café"]
SENTENCES = [
    "We present a new scientific document similarity model.",
    "Matching is computed over contextual sentence embeddings, 3 times.",
    "It's trained on co-citation contexts; they'll see 12 aspects.",
    "Café naïve résumé über alpha beta gamma.",
    "Queries specify the facet of similarity to retrieve by.",
    "delta epsilon zeta eta theta (alpha) 1,024.",
    "We analyze a range of models on this task.",
]
PAPERS = [{"TITLE": "t0", "ABSTRACT": SENTENCES[:3]},
          {"TITLE": "t1", "ABSTRACT": SENTENCES[3:4]},
          {"TITLE": "t2", "ABSTRACT": SENTENCES[4:]},
          {"TITLE": "t3", "ABSTRACT": [SENTENCES[1] + " " + SENTENCES[5],
                                       SENTENCES[0]]}]
SIZES = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=64, max_position_embeddings=130,
             layer_norm_eps=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_weights(model, seed: int):
    """Every float tensor of the model from a numpy seed: N(0, 0.02),
    LayerNorm scales 1 + N(0, 0.02)."""
    rng = np.random.default_rng(seed)
    sd = model.state_dict()
    for name, t in sd.items():
        if not t.is_floating_point():
            continue
        base = 1.0 if name.endswith("LayerNorm.weight") else 0.0
        t.copy_(torch.from_numpy((base + 0.02 * rng.standard_normal(t.shape))
                                 .astype(np.float32)))
    return model.eval()


def write_roberta_dir(path, seed: int = 0, prefixed: bool = False):
    path.mkdir(parents=True, exist_ok=True)
    trainer = ByteLevelBPETokenizer()
    trainer.train_from_iterator(SENTENCES * 3, vocab_size=400, min_frequency=1,
                                special_tokens=["<s>", "<pad>", "</s>", "<unk>",
                                                "<mask>"])
    trainer.save_model(str(path))
    tok = transformers.RobertaTokenizerFast(str(path / "vocab.json"),
                                            str(path / "merges.txt"))
    tok.save_pretrained(str(path))
    cfg = transformers.RobertaConfig(vocab_size=len(tok), type_vocab_size=1,
                                     pad_token_id=1, **SIZES)
    model = numpy_weights(transformers.RobertaModel(cfg), seed)
    if prefixed:
        cfg.save_pretrained(str(path))
        torch.save({"roberta." + k: v for k, v in model.state_dict().items()},
                   path / "pytorch_model.bin")
    else:
        model.save_pretrained(str(path), safe_serialization=False)
    return model, tok


def mpnet_vocab() -> list:
    pieces = ["##" + c for c in "abcdefghijklmnopqrstuvwxyz"]
    chars = list("abcdefghijklmnopqrstuvwxyz0123456789.,;()'") + ["é", "ï", "ü"]
    return (["<s>", "<pad>", "</s>", "<unk>", "[UNK]"] + WORDS + chars + pieces
            + ["<mask>"])


def write_mpnet_dir(path, seed: int = 0):
    path.mkdir(parents=True, exist_ok=True)
    vocab = mpnet_vocab()
    (path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    tok = transformers.MPNetTokenizerFast(str(path / "vocab.txt"),
                                          unk_token="[UNK]")
    tok.save_pretrained(str(path))
    cfg = transformers.MPNetConfig(vocab_size=len(vocab),
                                   relative_attention_num_buckets=32, **SIZES)
    model = numpy_weights(transformers.MPNetModel(cfg), seed)
    model.save_pretrained(str(path), safe_serialization=False)
    return model, tok


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("families")
    return {"roberta": (root / "roberta", *write_roberta_dir(root / "roberta", 1)),
            "mpnet": (root / "mpnet", *write_mpnet_dir(root / "mpnet", 2))}


def _batch(tok, texts):
    enc = tok(texts, padding="longest", return_tensors="np")
    return enc["input_ids"], enc["attention_mask"]


def test_relative_position_bucket_equals_hf():
    rel = torch.arange(-513, 514)[None, :]
    want = transformers.models.mpnet.modeling_mpnet.MPNetEncoder \
        .relative_position_bucket(rel, num_buckets=32, max_distance=128)
    assert torch.equal(relative_position_bucket(rel, 32), want)


def test_roberta_position_ids_equal_hf():
    from transformers.models.roberta.modeling_roberta import (
        create_position_ids_from_input_ids)
    ids = torch.tensor([[0, 5, 6, 7, 2, 1, 1], [0, 9, 2, 1, 1, 1, 1],
                        [0, 1, 5, 2, 1, 4, 1]])
    assert torch.equal(position_ids_past_padding(ids, 1, 514).long(),
                       create_position_ids_from_input_ids(ids, 1))
    with pytest.raises(ValueError, match="max_position_embeddings"):
        position_ids_past_padding(torch.zeros((1, 513), dtype=torch.long), 1, 514)


@pytest.mark.parametrize("family", ["roberta", "mpnet"])
def test_tokenizer_ids_equal_hf(dirs, family):
    path, _, hf_tok = dirs[family]
    tok = load_hf_dir(path, "cpu").tokenizer
    for s in SENTENCES:
        assert tok.encode(s).tolist() == hf_tok(s, add_special_tokens=False)["input_ids"]
        ids = tok.build_inputs_with_special_tokens(tok.encode(s).tolist())
        assert ids == hf_tok(s)["input_ids"]
    assert tok.pad_token_id == hf_tok.pad_token_id


@pytest.mark.parametrize("family,ffn_impl", [("roberta", "naive"),
                                             ("roberta", "fused"),
                                             ("mpnet", "naive"),
                                             ("mpnet", "fused")])
def test_encoder_equals_hf_module(dirs, family, ffn_impl):
    path, hf_model, hf_tok = dirs[family]
    ids, mask = _batch(hf_tok, SENTENCES)
    with torch.no_grad():
        want = hf_model(input_ids=torch.from_numpy(ids),
                        attention_mask=torch.from_numpy(mask)).last_hidden_state
        model = load_hf_dir(path, "cpu").encoder_model(ffn_impl=ffn_impl)
        got, hidden = model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert len(hidden) == SIZES["num_hidden_layers"] + 1
    m = torch.from_numpy(mask).bool()
    np.testing.assert_allclose(got[m].numpy(), want[m].numpy(), atol=TOL, rtol=TOL)


def test_roberta_prefixed_weights(tmp_path):
    hf_model, hf_tok = write_roberta_dir(tmp_path / "p", 3, prefixed=True)
    ids, mask = _batch(hf_tok, SENTENCES[:3])
    with torch.no_grad():
        want = hf_model(input_ids=torch.from_numpy(ids),
                        attention_mask=torch.from_numpy(mask)).last_hidden_state
        got, _ = load_hf_dir(tmp_path / "p", "cpu").encoder_model()(
            torch.from_numpy(ids), torch.from_numpy(mask))
    m = torch.from_numpy(mask).bool()
    np.testing.assert_allclose(got[m].numpy(), want[m].numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("family,name", [("roberta", "sbrobertanli"),
                                         ("mpnet", "sbmpnet1B")])
def test_sbert_model_equals_jax_package(dirs, family, name):
    path = str(dirs[family][0])
    port = get_model(name, weights_dir=path, device="cpu")
    assert isinstance(port, SbertSimilarityModel)
    jax_ = JSbert(name, path)
    want = jax_.encode(PAPERS)
    # the same document in other batch compositions
    for batch in (PAPERS, PAPERS[:1], PAPERS[1:], PAPERS[2:3] + PAPERS[:2]):
        got = port.encode(batch)
        for g, p in zip(got, batch):
            w = want[PAPERS.index(p)]
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)
    got = port.encode(PAPERS)
    np.testing.assert_allclose(port.get_similarities(got[0], got[1:]),
                               jax_.get_similarities(want[0], want[1:]),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("family,name", [("roberta", "sbrobertanli"),
                                         ("mpnet", "sbmpnet1B")])
def test_evaluate_cli_equals_jax_evaluation(dirs, family, name, tmp_path, rng):
    root = tmp_path / "data"
    root.mkdir()
    make_eval_dataset(root, rng, WORDS[:8], n_queries=3, n_cands=6)
    out = cli.main(["evaluate", "--model", name, "--weights-dir",
                    str(dirs[family][0]), "--dataset", "toy", "--dataset-dir",
                    str(root), "--results", str(tmp_path / "port"),
                    "--device", "cpu"])
    want = j_run_evaluation(JSbert(name, str(dirs[family][0])),
                            JDataset("toy", str(root)), str(tmp_path / "jax"))
    assert set(out) == set(want)
    for key, splits in want.items():
        for split, vals in splits.items():
            for metric, v in vals.items():
                assert out[key][split][metric] == pytest.approx(v, abs=TOL)


def test_mpnet_special_tokens_from_addedtoken_dicts(tmp_path):
    """Newer tokenizer_config.json files store special tokens as AddedToken
    dicts: their content is read (not BERT's [CLS]/[SEP] defaults), and a
    special token the vocab lacks raises."""
    vocab = mpnet_vocab() + ["[CLS]", "[SEP]", "[PAD]"]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    added = lambda s: {"content": s, "lstrip": s == "<mask>", "normalized": False,
                       "rstrip": False, "single_word": False, "__type": "AddedToken"}
    cfg = {"do_lower_case": True, "bos_token": added("<s>"),
           "eos_token": added("</s>"), "cls_token": added("<s>"),
           "sep_token": added("</s>"), "pad_token": added("<pad>"),
           "unk_token": added("[UNK]"), "mask_token": added("<mask>")}
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(cfg))
    tok = FastWordPiece.from_dir(str(tmp_path))
    ids = tok.build_inputs_with_special_tokens(tok.encode("alpha beta").tolist())
    assert ids == [vocab.index("<s>"), vocab.index("alpha"), vocab.index("beta"),
                   vocab.index("</s>")]
    assert tok.pad_token_id == vocab.index("<pad>")
    cfg["mask_token"] = added("<not-there>")
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="not-there"):
        FastWordPiece.from_dir(str(tmp_path))
