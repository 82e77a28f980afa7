"""The first slice of the port as a whole, at a tiny size: the body of
`__graft_entry__.entry()`'s forward (ConSent encode -> MultiVec -> OT scoring
at temp 5000) and the two rerank functions, through both packages on the same
numpy inputs and bridged weights."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.core.types import MultiVec as JMV
from aspire_tpu.index import serve as jserve
from aspire_tpu.models.bert import BertConfig as JConfig
from aspire_tpu.models.encoders import ConSentEncoder as JEncoder
from aspire_tpu.ops.distances import wasserstein_dist as j_wasserstein
from aspire_tpu_torch.core.types import MultiVec as TMV
from aspire_tpu_torch.index import serve as tserve
from aspire_tpu_torch.models.bert import BertConfig
from aspire_tpu_torch.models.convert import state_dict_from_flax_params
from aspire_tpu_torch.models.encoders import ConSentEncoder
from aspire_tpu_torch.ops.distances import wasserstein_dist

B, T, MS = 4, 48, 6


def _setup(rng):
    cfg = JConfig.tiny()
    tok = rng.integers(5, cfg.vocab_size, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, 37:] = 0
    mask[3, 20:] = 0
    sent = np.full((B, T), -1, np.int32)
    lens = np.array([MS, MS - 2, MS, 1], np.int32)
    for i in range(B):                   # consecutive sentences after [CLS]
        per = 6
        for s in range(lens[i]):
            sent[i, 1 + s * per: 1 + (s + 1) * per] = s
    sent[mask == 0] = -1
    enc = JEncoder(cfg, max_sents=MS)
    params = enc.init(jax.random.key(0), tok, mask, sent)["params"]
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        params)
    port = ConSentEncoder(BertConfig.tiny(), max_sents=MS, device="cpu").eval()
    port.load_state_dict(state_dict_from_flax_params(params, cfg))
    return enc, params, port, tok, mask, sent, lens


@pytest.mark.parametrize("j_solver,t_solver", [("xla", "torch"),
                                               ("pallas", "kernel")])
def test_entry_forward_matches(rng, j_solver, t_solver):
    enc, params, port, tok, mask, sent, lens = _setup(rng)

    def forward(params, token_ids, attn_mask, sent_ids, abs_lens):
        cls, sents = enc.apply({"params": params}, token_ids, attn_mask, sent_ids)
        mv = JMV(embed=sents, lens=abs_lens)
        # the candidates are the batch rolled by one, so no pair is trivial
        other = JMV(embed=jnp.roll(sents, 1, axis=0), lens=jnp.roll(abs_lens, 1))
        sims, _ = j_wasserstein(mv, other, temp=5000.0, return_pair_sims=True,
                                solver=j_solver)
        return cls, sents, sims

    cls_j, sents_j, sims_j = forward(params, tok, mask, sent, jnp.asarray(lens))
    with torch.inference_mode():
        cls_t, sents_t = port(torch.from_numpy(tok).long(), torch.from_numpy(mask),
                              torch.from_numpy(sent).long())
        tl = torch.from_numpy(lens)
        sims_t, _ = wasserstein_dist(
            TMV(sents_t, tl), TMV(sents_t.roll(1, 0), tl.roll(1)), temp=5000.0,
            return_pair_sims=True, solver=t_solver)
    # encoder: f32 products, LayerNorms and softmaxes in another order
    np.testing.assert_allclose(cls_t.numpy(), np.asarray(cls_j), atol=1e-4)
    np.testing.assert_allclose(sents_t.numpy(), np.asarray(sents_j), atol=1e-4)
    # scores: ~70 annealing rounds, then exp(. / blur) with blur 0.05
    np.testing.assert_allclose(sims_t.numpy(), np.asarray(sims_j),
                               rtol=2e-3, atol=2e-3)
    assert np.isfinite(sims_t.numpy()).all()


def _rerank_inputs(rng, k=7, s=6, d=16):
    qe = rng.normal(size=(1, s, d)).astype(np.float32)
    ql = np.array([4], np.int32)
    ce = rng.normal(size=(k, s, d)).astype(np.float32)
    cl = rng.integers(1, s + 1, k).astype(np.int32)
    qe *= (np.arange(s)[None, :] < ql[:, None])[:, :, None]
    ce *= (np.arange(s)[None, :] < cl[:, None])[:, :, None]
    ce[0, :4] = qe[0, :4]               # candidate 0 is the query itself
    cl[0] = 4
    return qe, ql, ce, cl


@pytest.mark.parametrize("j_solver,t_solver", [("pallas", "kernel"),
                                               ("xla", "torch")])
def test_ot_rerank_matches(rng, j_solver, t_solver):
    qe, ql, ce, cl = _rerank_inputs(rng)
    want = jserve.ot_rerank(JMV(jnp.asarray(qe), jnp.asarray(ql)),
                            JMV(jnp.asarray(ce), jnp.asarray(cl)),
                            temp=5000.0, solver=j_solver)
    got = tserve.ot_rerank(TMV(torch.from_numpy(qe), torch.from_numpy(ql)),
                           TMV(torch.from_numpy(ce), torch.from_numpy(cl)),
                           temp=5000.0, solver=t_solver)
    assert got.shape == (7,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-3)
    assert int(np.argmax(got.numpy())) == 0 == int(np.argmax(np.asarray(want)))


def test_ot_rerank_defaults_to_the_kernel_solver(rng):
    import inspect
    assert inspect.signature(tserve.ot_rerank).parameters["solver"].default == "kernel"


def test_l2max_rerank_matches(rng):
    qe, ql, ce, cl = _rerank_inputs(rng)
    want = jserve.l2max_rerank(JMV(jnp.asarray(qe), jnp.asarray(ql)),
                               JMV(jnp.asarray(ce), jnp.asarray(cl)))
    got = tserve.l2max_rerank(TMV(torch.from_numpy(qe), torch.from_numpy(ql)),
                              TMV(torch.from_numpy(ce), torch.from_numpy(cl)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert float(got[0]) == 0.0


# ---- the index slice as a whole: corpus -> reps -> index -> fused query -----
class _WordTokenizer:
    """The four members `prepare_abstracts` asks of a tokenizer."""

    pad_token_id = 0

    def __init__(self, vocab):
        self.ids = {w: i for i, w in enumerate(vocab)}

    def tokenize(self, text):
        return text.lower().split()

    def convert_tokens_to_ids(self, tokens):
        return [self.ids.get(t, 1) for t in tokens]

    def build_inputs_with_special_tokens(self, token_ids_0):
        return [2] + list(token_ids_0) + [3]


@pytest.mark.parametrize("storage", ["bfloat16", "int8"])
def test_corpus_to_answered_query_matches(rng, storage):
    """encode_corpus in both packages (same corpus, tokenizer and bridged
    weights) -> same reps -> same dense index -> same fused-query answer."""
    import ml_dtypes
    from aspire_tpu.core.config import ModelHParams as JHP
    from aspire_tpu.index import build as jbuild, dense as jdense
    from aspire_tpu.models.doc_models import build_model as j_build_model
    from aspire_tpu_torch.core.config import ModelHParams as THP
    from aspire_tpu_torch.index import build as tbuild, dense as tdense
    from aspire_tpu_torch.models.convert import model_state_dict_from_flax_params
    from aspire_tpu_torch.models.doc_models import build_model as t_build_model

    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta"]
    tok = _WordTokenizer(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "title"]
                         + words)
    corpus = [{"TITLE": "title " + str(rng.choice(words)), "ABSTRACT": [
        " ".join(rng.choice(words, int(rng.integers(2, 5))))
        for _ in range(int(rng.integers(1, 5)))]} for _ in range(10)]
    kw = dict(model_name="miswordbienc", score_aggregation="l2max", max_sents=4)
    cfg = JConfig.tiny()
    jmodel = j_build_model(JHP(**kw), cfg)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        jmodel.init_params(jax.random.key(0)))
    tmodel = t_build_model(THP(**kw), BertConfig.tiny(), device="cpu")
    tmodel.load_state_dict(model_state_dict_from_flax_params(
        params, "miswordbienc", cfg))
    enc_kw = dict(batch_size=4, seq_len=32, max_sents=4)
    reps_j, cls_j = jbuild.encode_corpus(jmodel, params, corpus, tok, **enc_kw)
    reps_t, cls_t = tbuild.encode_corpus(tmodel, corpus, tok, **enc_kw)
    assert tmodel.training                 # the caller's mode is put back
    assert len(reps_t) == 10 and cls_t.shape == (10, 32)
    np.testing.assert_allclose(cls_t, cls_j, atol=1e-4)
    for a, b in zip(reps_t, reps_j):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=1e-4)
    # a bare encoder gives what the document model gives
    reps_e, _ = tbuild.encode_corpus(tmodel.encoder, corpus, tok, **enc_kw)
    for a, b in zip(reps_e, reps_t):
        np.testing.assert_array_equal(a, b)

    pids = [f"p{i}" for i in range(10)]
    int8 = storage == "int8"
    if int8:        # quantised on the "device": equal to the host's int8 build
        quant, _ = tbuild.encode_corpus(tmodel, corpus, tok, quantize=True, **enc_kw)
        tidx = tdense.build_dense_index_prequantized(quant, pids)
        host = tdense.build_dense_index(reps_t, pids, dtype="int8")
        for bq, bh in zip(tidx.buckets, host.buckets):
            np.testing.assert_array_equal(bq["sents"], bh["sents"])
            np.testing.assert_array_equal(bq["scales"], bh["scales"])
        jidx = jdense.build_dense_index(reps_j, pids, dtype="int8")
    else:
        tidx = tdense.build_dense_index(reps_t, pids)
        jidx = jdense.build_dense_index(reps_j, pids, dtype=ml_dtypes.bfloat16)
    # reps agree to 1e-4, so stored values agree to a rounding step of storage
    for tb, jb in zip(tidx.buckets, jidx.buckets):
        np.testing.assert_array_equal(tb["doc_idx"], jb["doc_idx"])
        if int8:
            assert np.abs(tb["sents"].astype(np.int32)
                          - jb["sents"].astype(np.int32)).max() <= 1
        else:
            got = tbuild.bf16_bits_to_f32(tb["sents"])
            want = np.asarray(jb["sents"]).astype(np.float32)
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-4)
    # a document's own sentences: it ranks itself first, at distance ~0
    q = np.zeros((8, 32), np.float32)
    q[:len(reps_t[7])] = reps_t[7]
    want = jserve.make_fused_query(len(jidx.buckets), k=5, max_sents=4,
                                   int8=int8, temp=5.0)(
        jnp.asarray(q), jnp.int32(len(reps_t[7])),
        *jdense.flatten_device_buckets(jidx.device_arrays()),
        *jidx.device_pos_arrays())
    v, d, s = tserve.make_fused_query(len(tidx.buckets), k=5, max_sents=4,
                                      int8=int8, temp=5.0)(
        torch.from_numpy(q), len(reps_t[7]),
        *tdense.flatten_device_buckets(tidx.device_arrays("cpu")),
        *tidx.device_pos_arrays("cpu"))
    assert int(d[0]) == 7 == int(want[1][0]) and abs(float(v[0])) < 2e-2
    np.testing.assert_array_equal(d.numpy(), np.asarray(want[1]))
    # storage steps of ~1e-2 relative on both sides
    np.testing.assert_allclose(v.numpy(), np.asarray(want[0]), atol=5e-2)
    np.testing.assert_allclose(s.numpy(), np.asarray(want[2]), rtol=5e-2, atol=5e-2)
    assert int(torch.argmax(s)) == 0
