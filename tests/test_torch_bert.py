"""Port parity: models/bert.py and models/encoders.py against the Flax
modules on bridged weights and the same numpy inputs, in float32.

atol 1e-4: two layers of f32 products, LayerNorms (Flax takes the variance as
E[x^2] - E[x]^2, PyTorch as E[(x - E[x])^2]) and softmaxes in another
summation order; with the Pallas FFN on the JAX side also its polynomial erf.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.models import bert as jb
from aspire_tpu.models import encoders as je
from aspire_tpu_torch.models import bert as tb
from aspire_tpu_torch.models import encoders as te
from aspire_tpu_torch.models.convert import state_dict_from_flax_params

ATOL = 1e-4
B, T, MS = 3, 40, 5


def _inputs(rng, cfg):
    tok = rng.integers(5, cfg.vocab_size, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, 29:] = 0                              # attention padding
    mask[2, 11:] = 0
    typ = rng.integers(0, 2, (B, T)).astype(np.int32)
    sent = np.clip(rng.integers(-1, MS, (B, T)), -1, MS - 1).astype(np.int32)
    sent[mask == 0] = -1
    return tok, mask, typ, sent


def _flax_params(module, rng, *args):
    """Init, then move every leaf off its init value (zeros biases, unit
    scales) with seeded numpy noise so that no term of the model is idle."""
    params = module.init(jax.random.key(0), *args)["params"]
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        params)


def _load(module, params, cfg=None):
    module.load_state_dict(state_dict_from_flax_params(params, cfg))
    return module.eval()


def _long(*arrs):
    return [torch.from_numpy(a).long() for a in arrs]


@pytest.mark.parametrize("j_ffn,t_attn,t_ffn", [
    ("auto", "auto", "auto"),            # both naive off the accelerator
    ("fused", "fused_det", "fused"),     # Pallas FFN (interpret) vs the plain
                                         # versions of the port's kernels
], ids=["naive", "fused"])
def test_bert_model_all_hidden_states(rng, j_ffn, t_attn, t_ffn):
    cfg = jb.BertConfig.tiny()
    tok, mask, typ, _ = _inputs(rng, cfg)
    jm = jb.BertModel(cfg, ffn_impl=j_ffn)
    params = _flax_params(jm, rng, tok, mask, typ)
    last_j, hs_j = jm.apply({"params": params}, tok, mask, typ)
    tm = _load(tb.BertModel(tb.BertConfig.tiny(), attention_impl=t_attn,
                            ffn_impl=t_ffn, device="cpu"), params, cfg)
    with torch.inference_mode():
        last_t, hs_t = tm(*_long(tok, mask, typ))
    assert len(hs_t) == len(hs_j) == cfg.num_hidden_layers + 1
    for h_t, h_j in zip(hs_t, hs_j):
        assert h_t.dtype == torch.float32
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL)
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j), atol=ATOL)


def test_bert_model_bf16_tracks_flax_bf16(rng):
    """Same rounding points (dense outputs, embeddings before the sum,
    LayerNorm in f32): bf16 against bf16 stays within a few bf16 ulps (2^-7
    at O(1) states) a layer."""
    cfg = jb.BertConfig.tiny()
    tok, mask, typ, _ = _inputs(rng, cfg)
    jm = jb.BertModel(cfg, dtype=jnp.bfloat16)
    params = _flax_params(jb.BertModel(cfg), rng, tok, mask, typ)
    last_j, _ = jm.apply({"params": params}, tok, mask, typ)
    tm = _load(tb.BertModel(tb.BertConfig.tiny(), dtype=torch.bfloat16,
                            device="cpu"), params, cfg)
    with torch.inference_mode():
        last_t, _ = tm(*_long(tok, mask, typ))
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j), atol=8e-2)


def test_bert_pooler(rng):
    cfg = jb.BertConfig.tiny()
    last = rng.normal(size=(B, T, cfg.hidden_size)).astype(np.float32)
    jp = jb.BertPooler(cfg)
    params = _flax_params(jp, rng, last)
    want = jp.apply({"params": params}, last)
    tp = _load(tb.BertPooler(tb.BertConfig.tiny(), device="cpu"), params)
    with torch.inference_mode():
        got = tp(torch.from_numpy(last))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("j_ffn,t_ffn", [("auto", "auto"), ("fused", "fused")])
def test_consent_encoder(rng, j_ffn, t_ffn):
    cfg = jb.BertConfig.tiny()
    tok, mask, _, sent = _inputs(rng, cfg)
    jm = je.ConSentEncoder(cfg, max_sents=MS, ffn_impl=j_ffn)
    params = _flax_params(jm, rng, tok, mask, sent)
    cls_j, sents_j = jm.apply({"params": params}, tok, mask, sent)
    tm = _load(te.ConSentEncoder(tb.BertConfig.tiny(), max_sents=MS,
                                 ffn_impl=t_ffn, device="cpu"), params, cfg)
    with torch.inference_mode():
        cls_t, sents_t = tm(*_long(tok, mask, sent))
    assert sents_t.shape == (B, MS, cfg.hidden_size)
    np.testing.assert_allclose(cls_t.numpy(), np.asarray(cls_j), atol=ATOL)
    np.testing.assert_allclose(sents_t.numpy(), np.asarray(sents_j), atol=ATOL)


def test_consent_span_encoder(rng):
    cfg = jb.BertConfig.tiny()
    tok, mask, _, sent = _inputs(rng, cfg)
    spans = (rng.random((B, 4, T)) < 0.15).astype(np.float32)
    spans[:, 3] = 0.0                               # an empty span
    jm = je.ConSentSpanEncoder(cfg, max_sents=MS)
    params = _flax_params(jm, rng, tok, mask, sent, spans)
    want = jm.apply({"params": params}, tok, mask, sent, spans)
    tm = _load(te.ConSentSpanEncoder(tb.BertConfig.tiny(), max_sents=MS,
                                     device="cpu"), params, cfg)
    with torch.inference_mode():
        got = tm(*_long(tok, mask, sent), torch.from_numpy(spans))
    assert len(got) == 3 and float(got[2][:, 3].abs().max()) == 0.0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_bi_encoder(rng):
    cfg = jb.BertConfig.tiny()
    tok, mask, typ, _ = _inputs(rng, cfg)
    jm = je.BiEncoder(cfg)
    params = _flax_params(jm, rng, tok, mask, typ)
    want = jm.apply({"params": params}, tok, mask, typ)
    tm = _load(te.BiEncoder(tb.BertConfig.tiny(), device="cpu"), params, cfg)
    with torch.inference_mode():
        got = tm(*_long(tok, mask, typ))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_pooling_functions(rng):
    hidden = rng.normal(size=(B, T, 8)).astype(np.float32)
    sent = np.clip(rng.integers(-1, MS, (B, T)), -1, MS - 2).astype(np.int32)
    got = te.sentence_pool(torch.from_numpy(hidden), torch.from_numpy(sent), MS)
    want = je.sentence_pool(jnp.asarray(hidden), jnp.asarray(sent), MS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert float(got[:, MS - 1].abs().max()) == 0.0   # no tokens -> zero vector


@pytest.mark.parametrize("impl", ["auto", "fused", "fused_det", "naive"])
@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("on_cuda", [True, False])
def test_select_impl_policy_table(impl, deterministic, p, on_cuda):
    got = tb._select_impl(impl, deterministic, p, on_cuda=on_cuda)
    if impl == "fused_det":
        want = "fused_det"
    elif impl == "naive":
        want = "naive"
    else:
        # same table as the JAX package, with CUDA in the place of the TPU
        want = jb._select_impl(impl, deterministic, p, on_tpu=on_cuda)
    assert got == want
    with pytest.raises(ValueError):
        tb._select_impl("flash", deterministic, p, on_cuda=on_cuda)


@pytest.mark.parametrize("impl", ["auto", "fused", "naive"])
@pytest.mark.parametrize("on_cuda", [True, False])
def test_select_ffn_policy_table(impl, on_cuda):
    assert tb._select_ffn(impl, on_cuda=on_cuda) == jb._select_ffn(impl, on_tpu=on_cuda)
    with pytest.raises(ValueError):
        tb._select_ffn("pallas", on_cuda=on_cuda)


def test_over_long_sequence_raises(rng):
    cfg = tb.BertConfig.tiny(max_position_embeddings=16)
    model = tb.BertModel(cfg, device="cpu").eval()
    tok = torch.zeros((1, 17), dtype=torch.long)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        model(tok, torch.ones_like(tok))


def test_train_mode_with_dropout_raises_and_cuda_default_is_explicit(rng):
    cfg = tb.BertConfig.tiny()
    model = tb.BertModel(cfg, device="cpu")         # a fresh module is in train()
    tok = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="needs the encode's seed"):
        model(tok, torch.ones_like(tok))            # dropout without a seed
    last, _ = model(tok, torch.ones_like(tok), seed=3)
    assert bool(torch.isfinite(last).all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            te.ConSentEncoder(cfg)                  # default device is the GPU


def test_cast_cache_follows_parameter_updates(rng):
    cfg = tb.BertConfig.tiny()
    model = tb.BertModel(cfg, dtype=torch.bfloat16, ffn_impl="fused",
                         device="cpu").eval()
    tok = torch.from_numpy(rng.integers(5, cfg.vocab_size, (2, 8)))
    mask = torch.ones_like(tok)
    with torch.inference_mode():
        first, _ = model(tok, mask)
        again, _ = model(tok, mask)
    np.testing.assert_array_equal(first.numpy(), again.numpy())
    with torch.no_grad():
        model.layer_0.intermediate_dense.weight.mul_(1.5)
        model.layer_1.attention_self.query.bias.add_(0.5)
    with torch.inference_mode():
        moved, _ = model(tok, mask)
    assert float((moved - first).abs().max()) > 1e-3


# ---- train() mode -----------------------------------------------------------
def _train_inputs(rng, cfg):
    tok, mask, typ, _ = _inputs(rng, cfg)
    return (torch.from_numpy(tok).long(), torch.from_numpy(mask).long(),
            torch.from_numpy(typ).long())


@pytest.mark.parametrize("impls", ["auto", "fused", "naive"])
def test_train_mode_bf16_runs_backward_and_gives_f32_gradients(rng, impls):
    cfg = tb.BertConfig.tiny()
    model = tb.BertModel(cfg, dtype=torch.bfloat16, attention_impl=impls,
                         ffn_impl=impls, hidden_dropout_impl=impls, device="cpu")
    assert model.training
    tok, mask, typ = _train_inputs(rng, cfg)
    last, hidden = model(tok, mask, typ, seed=17)
    assert last.dtype == torch.float32 and len(hidden) == cfg.num_hidden_layers + 1
    last.square().mean().backward()
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert bool(torch.isfinite(p.grad).all()), name
    assert float(model.layer_0.intermediate_dense.weight.grad.abs().max()) > 0
    # the same seed gives the same pass, another seed another one
    again, _ = model(tok, mask, typ, seed=17)
    other, _ = model(tok, mask, typ, seed=18)
    assert torch.equal(last, again) and not torch.equal(last, other)


def test_dropout_sites_dtypes_and_attention_sites(rng, monkeypatch):
    """25 hidden sites an encode at 12 layers, here 1 + 2 * layers: site 0 on
    the f32 LayerNorm output, 1 + 2i and 2 + 2i on the compute dtype; the
    attention site is the layer index; one seed serves them all."""
    cfg = tb.BertConfig.tiny(num_hidden_layers=3)
    model = tb.BertModel(cfg, dtype=torch.bfloat16, attention_impl="fused",
                         hidden_dropout_impl="fused", device="cpu")
    hidden, attention = [], []
    real_dropout, real_attention = tb.fused_dropout, tb.fused_attention

    def spy_dropout(x, p, *, seed, site):
        hidden.append((site, x.dtype, p, seed))
        return real_dropout(x, p, seed=seed, site=site)

    def spy_attention(q, k, v, bias, scale, p=0.0, *, seed=None, site=0):
        attention.append((site, p, seed))
        return real_attention(q, k, v, bias, scale, p, seed=seed, site=site)

    monkeypatch.setattr(tb, "fused_dropout", spy_dropout)
    monkeypatch.setattr(tb, "fused_attention", spy_attention)
    model(*_train_inputs(rng, cfg), seed=99)
    assert [s for s, *_ in hidden] == list(range(1 + 2 * 3))
    assert hidden[0][1] == torch.float32
    assert {d for _, d, *_ in hidden[1:]} == {torch.bfloat16}
    assert {(p, seed) for _, _, p, seed in hidden} == {(0.1, 99)}
    assert attention == [(i, 0.1, 99) for i in range(3)]
    hidden.clear(), attention.clear()
    model.eval()
    model(*_train_inputs(rng, cfg))
    assert hidden == [] and attention == []           # eval: identity, naive


def test_select_hidden_dropout_policy():
    sel = tb._select_hidden_dropout
    assert sel("auto", on_cuda=True) == "fused"
    assert sel("auto", on_cuda=False) == "naive"
    assert sel("fused", on_cuda=False) == "fused"
    assert sel("naive", on_cuda=True) == "naive"
    with pytest.raises(ValueError, match="hidden_dropout_impl"):
        sel("flash")
    assert tb._select_impl("auto", False, 0.1, on_cuda=True) == "fused"
    assert tb._select_impl("auto", False, 0.0, on_cuda=True) == "fused_det"
    assert tb._select_impl("fused", False, 0.1, on_cuda=False) == "fused"
    assert tb._select_impl("auto", False, 0.1, on_cuda=False) == "naive"


def test_cast_copies_are_cached_without_grad_and_in_graph_with_it(rng):
    cfg = tb.BertConfig.tiny(hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    layer = tb.BertLayer(cfg, dtype=torch.bfloat16, ffn_impl="fused", device="cpu")
    x = torch.from_numpy(rng.standard_normal((2, 5, cfg.hidden_size))
                         .astype(np.float32)).bfloat16()
    bias = torch.zeros((2, 5))
    with torch.no_grad():
        a = layer(x, bias)
    cached = dict(layer._cache._store)
    assert cached and all(not v[1].requires_grad for v in cached.values())
    out = layer(x, bias)                              # under grad: no cache use
    assert {k: id(v[1]) for k, v in layer._cache._store.items()} \
        == {k: id(v[1]) for k, v in cached.items()}
    out.float().sum().backward()
    w = layer.intermediate_dense.weight
    assert w.grad is not None and w.grad.dtype == torch.float32
    assert w.grad.shape == w.shape
    # the training forward rounds the FFN pre-activation; the no-grad kernel
    # path does not: a few bf16 ulps apart at most
    assert float((a.float() - out.detach().float()).abs().max()) < 0.1
