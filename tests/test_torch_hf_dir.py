"""Loading a local HF BERT directory without `transformers`
(models/convert.load_hf_dir): a tiny BERT saved by `transformers` as
pytorch_model.bin and as model.safetensors -- with and without a "bert."
prefix, with and without a pooler, with the old gamma/beta names -- encodes
like the HF model itself and like the JAX package's `from_hf_dir` within
1e-4; the safetensors reader is held against the `safetensors` package."""
import json

import numpy as np
import pytest
import torch
import transformers

from aspire_tpu.evaluation.models import (
    AspireSimilarityModel as JAspire, TrainedSentSimilarityModel as JTrainedSent)
from aspire_tpu_torch.evaluation.models import (AspireSimilarityModel,
                                                TrainedSentSimilarityModel)
from aspire_tpu_torch.models.bert import BertPooler
from aspire_tpu_torch.models.convert import load_hf_dir, read_safetensors

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta"]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "title", "."] + WORDS
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test workers share the machine's cores: torch's intra-op pool at its
    default size oversubscribes them, and this file's many small ops then
    run tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hf_config():
    return transformers.BertConfig(
        vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64, max_position_embeddings=64)


def write_hf_dir(path, layout: str, seed: int = 0):
    """layout: 'bin', 'safetensors', 'bin_prefixed' (BertForPreTraining-style
    "bert." keys plus an MLM head) or 'bin_gamma' (LayerNorm gamma/beta)."""
    torch.manual_seed(seed)
    model = transformers.BertModel(hf_config()).eval()
    path.mkdir(parents=True, exist_ok=True)
    (path / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "BertTokenizer", "do_lower_case": True}))
    if layout in ("bin", "safetensors"):
        model.save_pretrained(path, safe_serialization=layout == "safetensors")
        return model
    model.config.save_pretrained(path)
    sd = model.state_dict()
    if layout == "bin_prefixed":
        sd = {"bert." + k: v for k, v in sd.items()}
        sd["cls.predictions.bias"] = torch.zeros(len(VOCAB))
    else:
        sd = {k.replace("LayerNorm.weight", "LayerNorm.gamma")
              .replace("LayerNorm.bias", "LayerNorm.beta"): v
              for k, v in sd.items()}
    torch.save(sd, path / "pytorch_model.bin")
    return model


PAPERS = [{"TITLE": "title alpha", "ABSTRACT": ["alpha beta gamma.",
                                                "delta epsilon zeta eta."]},
          {"TITLE": "title", "ABSTRACT": ["theta alpha.", "beta beta beta.",
                                          "gamma."]},
          {"TITLE": "title beta", "ABSTRACT": ["zeta eta theta alpha beta."]}]


@pytest.mark.parametrize("layout", ["bin", "safetensors", "bin_prefixed",
                                    "bin_gamma"])
def test_load_hf_dir_encodes_like_hf(tmp_path, rng, layout):
    hf = write_hf_dir(tmp_path / layout, layout)
    files = {p.name for p in (tmp_path / layout).iterdir()}
    assert ("model.safetensors" in files) == (layout == "safetensors")
    ckpt = load_hf_dir(tmp_path / layout, "cpu")
    assert ckpt.config.vocab_size == len(VOCAB) and ckpt.config.hidden_size == 32
    assert ckpt.tokenizer.vocab_size == len(VOCAB)
    ids = rng.integers(5, len(VOCAB), (3, 20))
    mask = np.ones((3, 20), np.int64)
    mask[1, 13:] = 0
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids),
                  attention_mask=torch.from_numpy(mask)).last_hidden_state
        got, _ = ckpt.encoder_model()(torch.from_numpy(ids), torch.from_numpy(mask))
        pooler = BertPooler(ckpt.config, device="cpu")
        pooler.load_state_dict(ckpt.pooler_state_dict())
        pooled = pooler(got)
        want_pooled = hf.pooler(want)
    np.testing.assert_allclose(got.numpy()[mask > 0], want.numpy()[mask > 0],
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(pooled.numpy(), want_pooled.numpy(),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("layout", ["bin", "safetensors"])
def test_aspire_from_hf_dir_matches_jax(tmp_path, layout):
    write_hf_dir(tmp_path / layout, layout, seed=3)
    kw = dict(agg="ot", max_sents=4, ot_temp=5000.0)
    port = AspireSimilarityModel.from_hf_dir("m", str(tmp_path / layout),
                                             device="cpu", **kw)
    jax_ = JAspire.from_hf_dir("m", str(tmp_path / layout), **kw)
    got, want = port.encode(PAPERS), jax_.encode(PAPERS)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)
    # no document against itself: at distance 0 the Gram expansion's
    # cancellation rounds differently in the two packages (~1e-3)
    np.testing.assert_allclose(port.get_similarities(got[0], got[1:]),
                               jax_.get_similarities(want[0], want[1:]),
                               atol=TOL, rtol=TOL)


def test_pooler_head_matches_jax(tmp_path):
    write_hf_dir(tmp_path / "p", "bin", seed=5)
    port = TrainedSentSimilarityModel.from_hf_dir("simcse", str(tmp_path / "p"),
                                                  device="cpu")
    jax_ = JTrainedSent.from_hf_dir("simcse", str(tmp_path / "p"))
    for g, w in zip(port.encode(PAPERS), jax_.encode(PAPERS)):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)


def test_unsupported_model_type_is_refused(tmp_path):
    """BERT, RoBERTa and MPNet load (tests/test_torch_families.py); any other
    model type is refused by name, in load_hf_dir and in the sbert model."""
    write_hf_dir(tmp_path / "x", "bin")
    cfg = json.loads((tmp_path / "x" / "config.json").read_text())
    cfg["model_type"] = "xlnet"
    (tmp_path / "x" / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="xlnet"):
        load_hf_dir(tmp_path / "x", "cpu")
    from aspire_tpu_torch.evaluation.models import SbertSimilarityModel
    with pytest.raises(ValueError, match="xlnet"):
        SbertSimilarityModel("sbrobertanli", str(tmp_path / "x"), device="cpu")


def test_cuda_device_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    write_hf_dir(tmp_path / "c", "bin")
    with pytest.raises(RuntimeError, match="cuda"):
        load_hf_dir(tmp_path / "c")


def test_safetensors_reader_matches_the_package(tmp_path, rng):
    st = pytest.importorskip("safetensors.numpy")
    import ml_dtypes
    arrays = {"f32": rng.normal(size=(3, 5)).astype(np.float32),
              "f16": rng.normal(size=(7,)).astype(np.float16),
              "i64": rng.integers(-9, 9, (2, 2)).astype(np.int64),
              "bf16": rng.normal(size=(4, 3)).astype(ml_dtypes.bfloat16),
              "scalar": np.asarray(2.5, np.float32)}
    st.save_file(arrays, str(tmp_path / "x.safetensors"),
                 metadata={"format": "pt"})
    got = read_safetensors(tmp_path / "x.safetensors")
    assert set(got) == set(arrays)
    for k, v in arrays.items():
        want = v.astype(np.float32) if k == "bf16" else v
        assert got[k].shape == want.shape and got[k].dtype == want.dtype, k
        np.testing.assert_array_equal(got[k], want)
