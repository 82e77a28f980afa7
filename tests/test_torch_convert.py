"""Port: models/convert.py -- the Flax-tree bridge covers every parameter,
and the HF-layout route agrees with HF -> Flax -> port."""
import numpy as np
import jax
import pytest
import torch

from aspire_tpu.models import bert as jb
from aspire_tpu.models import convert as jc
from aspire_tpu.models import encoders as je
from aspire_tpu_torch.models import bert as tb
from aspire_tpu_torch.models import convert as tc
from aspire_tpu_torch.models import encoders as te


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _init(module, *args):
    return _np_tree(module.init(jax.random.key(1), *args)["params"])


TOK = np.ones((1, 6), np.int32)


@pytest.mark.parametrize("name", ["ConSentEncoder", "ConSentSpanEncoder",
                                  "BiEncoder", "BertModel", "BertPooler"])
def test_flax_bridge_covers_every_parameter(name):
    cfg, tcfg = jb.BertConfig.tiny(), tb.BertConfig.tiny()
    if name == "BertPooler":
        params = _init(jb.BertPooler(cfg), np.zeros((1, 6, cfg.hidden_size), np.float32))
        module = tb.BertPooler(tcfg, device="cpu")
    elif name == "BertModel":
        params = _init(jb.BertModel(cfg), TOK, TOK)
        module = tb.BertModel(tcfg, device="cpu")
    elif name == "BiEncoder":
        params = _init(je.BiEncoder(cfg), TOK, TOK)
        module = te.BiEncoder(tcfg, device="cpu")
    elif name == "ConSentSpanEncoder":
        params = _init(je.ConSentSpanEncoder(cfg, max_sents=3), TOK, TOK, TOK,
                       np.zeros((1, 2, 6), np.float32))
        module = te.ConSentSpanEncoder(tcfg, max_sents=3, device="cpu")
    else:
        params = _init(je.ConSentEncoder(cfg, max_sents=3), TOK, TOK, TOK)
        module = te.ConSentEncoder(tcfg, max_sents=3, device="cpu")
    state = tc.state_dict_from_flax_params(params, cfg)
    # no key missing, none unused, and as many values as the Flax tree holds
    assert set(state) == set(module.state_dict())
    result = module.load_state_dict(state, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    n_flax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    assert sum(v.numel() for v in state.values()) == n_flax
    for key, val in state.items():
        assert val.dtype == torch.float32
        assert val.shape == module.state_dict()[key].shape


def test_flax_bridge_transposes_dense_and_renames(rng):
    kernel = rng.normal(size=(4, 7)).astype(np.float32)
    tree = {"bert": {"layer_0": {"output_dense": {
        "kernel": kernel, "bias": np.arange(7, dtype=np.float32)},
        "output_LayerNorm": {"scale": np.ones(7, np.float32),
                             "bias": np.zeros(7, np.float32)}},
        "embeddings": {"word_embeddings": {"embedding": kernel}}},
        "layer_weights": np.zeros(13, np.float32)}
    state = tc.state_dict_from_flax_params(tree)
    np.testing.assert_array_equal(
        state["bert.layer_0.output_dense.weight"].numpy(), kernel.T)
    assert state["bert.layer_0.output_LayerNorm.weight"].shape == (7,)
    np.testing.assert_array_equal(
        state["bert.embeddings.word_embeddings.weight"].numpy(), kernel)
    assert state["layer_weights"].shape == (13,)
    with pytest.raises(ValueError, match="layers"):
        tc.state_dict_from_flax_params(tree, tb.BertConfig.tiny())


def _hf_state_dict(rng, cfg, prefix="bert."):
    h, f = cfg.hidden_size, cfg.intermediate_size
    n = lambda *s: rng.normal(size=s).astype(np.float32)
    sd = {"embeddings.word_embeddings.weight": n(cfg.vocab_size, h),
          "embeddings.position_embeddings.weight": n(cfg.max_position_embeddings, h),
          "embeddings.token_type_embeddings.weight": n(cfg.type_vocab_size, h),
          "embeddings.LayerNorm.weight": n(h), "embeddings.LayerNorm.bias": n(h),
          "pooler.dense.weight": n(h, h), "pooler.dense.bias": n(h)}
    for i in range(cfg.num_hidden_layers):
        p = f"encoder.layer.{i}"
        for name, (o, k) in {
                "attention.self.query": (h, h), "attention.self.key": (h, h),
                "attention.self.value": (h, h), "attention.output.dense": (h, h),
                "intermediate.dense": (f, h), "output.dense": (h, f)}.items():
            sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"] = n(o, k), n(o)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"] = n(h), n(h)
    return {prefix + k: v for k, v in sd.items()}


@pytest.mark.parametrize("prefix", ["bert.", ""])
def test_hf_route_equals_hf_to_flax_to_port(rng, prefix):
    cfg, tcfg = jb.BertConfig.tiny(), tb.BertConfig.tiny()
    hf = _hf_state_dict(rng, cfg, prefix)
    direct = tc.state_dict_from_hf_state_dict(hf, tcfg, prefix="bert.")
    via_flax = tc.state_dict_from_flax_params(
        {"bert": jc.params_from_hf_state_dict(hf, cfg)}, tcfg)
    assert set(direct) == set(via_flax)
    for key in direct:
        np.testing.assert_array_equal(direct[key].numpy(), via_flax[key].numpy())
    te.ConSentEncoder(tcfg, device="cpu").load_state_dict(direct, strict=True)
    # torch tensors are taken as well as arrays
    as_torch = {k: torch.from_numpy(v) for k, v in hf.items()}
    again = tc.state_dict_from_hf_state_dict(as_torch, tcfg, prefix="bert.")
    np.testing.assert_array_equal(again["bert.layer_1.output_dense.weight"].numpy(),
                                  direct["bert.layer_1.output_dense.weight"].numpy())


def test_hf_pooler_and_config(rng):
    cfg = tb.BertConfig.tiny()
    hf = _hf_state_dict(rng, cfg)
    pooler = tc.pooler_state_dict_from_hf_state_dict(hf)
    want = jc.pooler_params_from_hf_state_dict(hf)
    np.testing.assert_array_equal(pooler["dense.weight"].numpy(),
                                  want["dense"]["kernel"].T)
    tb.BertPooler(cfg, device="cpu").load_state_dict(pooler, strict=True)
    assert tc.pooler_state_dict_from_hf_state_dict(
        {k: v for k, v in hf.items() if "pooler" not in k}) is None

    class HFConfig:
        vocab_size, hidden_size, num_hidden_layers = 99, 48, 3
        num_attention_heads, intermediate_size = 6, 96
        max_position_embeddings, type_vocab_size, layer_norm_eps = 77, 2, 1e-12

    got, want = tc.config_from_hf(HFConfig), jc.config_from_hf(HFConfig)
    for field in ("vocab_size", "hidden_size", "num_hidden_layers",
                  "num_attention_heads", "intermediate_size",
                  "max_position_embeddings", "type_vocab_size", "layer_norm_eps"):
        assert getattr(got, field) == getattr(want, field)


def test_bienc_layer_weights_extraction():
    w = te.bienc_layer_weights_from_state_dict(
        {"bert_layer_weights.weight": torch.arange(13.0).reshape(1, 13)})
    assert w.shape == (13,) and float(w[12]) == 12.0
    with pytest.raises(KeyError):
        te.bienc_layer_weights_from_state_dict({})
