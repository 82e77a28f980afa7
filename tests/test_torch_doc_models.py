"""Port parity: models/doc_models.py against the JAX package's model zoo.

Every family of MODEL_REGISTRY is built on both sides at BertConfig.tiny()
with the dropout probabilities at 0 and train=True, the JAX model's initial
parameters (plus seeded noise) are bridged by models/convert.py, and the same
numpy batch goes through both: the training loss, its gradient for every
parameter (carried back through convert.py), the in-batch-negative mix with
the same permutation, the grouped loss, and score_reps.  float32 throughout.

Loss: rtol 1e-4 (two layers of f32 products, LayerNorms and softmaxes in
another summation order, then distances of O(1..10)).  Gradients: 1e-4 of the
larger of the parameter's gradient norm and 1% of the whole gradient's norm.

With dropout on (the port's own Philox masks, no JAX counterpart by design):
the same generator seed gives the same loss, another seed another loss, the
'naive' and 'fused' routes agree on the CPU, eval mode is the identity.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.core.config import ModelHParams as JHP
from aspire_tpu.core.types import MultiVec as JMultiVec
from aspire_tpu.models import bert as jb
from aspire_tpu.models import doc_models as jdm
from aspire_tpu_torch.core.config import ModelHParams as THP
from aspire_tpu_torch.core.types import MultiVec as TMultiVec
from aspire_tpu_torch.models import bert as tb
from aspire_tpu_torch.models import doc_models as tdm
from aspire_tpu_torch.models.convert import (flax_params_from_model_state_dict,
                                             model_state_dict_from_flax_params)

B, T, MS = 3, 24, 4
NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)

FAMILIES = {
    "cospecter": dict(model_name="cospecter"),
    "miswordbienc-l2max": dict(model_name="miswordbienc", score_aggregation="l2max"),
    "miswordbienc-ot": dict(model_name="miswordbienc",
                            score_aggregation="l2wasserstein", sent_sm_temp=5000.0),
    "miswordbienc-att": dict(model_name="miswordbienc",
                             score_aggregation="l2attention", cdatt_sm_temp=2.0),
    "miswordabsbienc": dict(model_name="miswordabsbienc", score_aggregation="l2top2",
                            abs_loss_prop=0.5, sent_loss_prop=0.7, cd_l1_prop=0.01),
    "miswordpolyenc": dict(model_name="miswordpolyenc"),
    "sbalisentbienc": dict(model_name="sbalisentbienc",
                           score_aggregation="l2wasserstein", sent_sm_temp=5000.0,
                           sent_loss_prop=1.0, sentsup_loss_prop=1.0,
                           abs_loss_prop=0.3),
    "sbalisentbienc-weighted": dict(model_name="sbalisentbienc",
                                    score_aggregation="l2max", weighted_sup=True,
                                    sent_loss_prop=0.0, sentsup_loss_prop=1.0),
}


def feats(rng, lead, vocab=128):
    shape = tuple(lead) + (T,)
    lens = rng.integers(2, MS + 1, lead)
    n_tok = rng.integers(T // 2, T + 1, lead)
    pos = np.broadcast_to(np.arange(T), shape)
    mask = (pos < n_tok[..., None]).astype(np.int32)
    sent = np.clip((pos - 1) * lens[..., None] // np.maximum(n_tok[..., None] - 1, 1),
                   0, lens[..., None] - 1)
    sent = np.where((mask > 0) & (pos > 0), sent, -1).astype(np.int32)
    tok = (rng.integers(5, vocab, shape) * mask).astype(np.int32)
    return {"token_ids": tok, "attn_mask": mask, "sent_ids": sent,
            "abs_lens": lens.astype(np.int32)}


def make_batch(rng, lead=(B,), neg=True):
    batch = {"query": feats(rng, lead), "pos": feats(rng, lead)}
    batch["pos"]["align"] = rng.integers(0, 2, tuple(lead) + (2,)).astype(np.int32)
    if neg:
        batch["neg"] = feats(rng, lead)
    return batch


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree)).long()


def build_pair(name, rng, cfg_kw=NO_DROP, **hp_kw):
    kw = dict(FAMILIES[name], max_sents=MS, **hp_kw)
    jmodel = jdm.build_model(JHP(**kw), jb.BertConfig.tiny(**cfg_kw))
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        jmodel.init_params(jax.random.key(0), seq_len=T))
    tmodel = tdm.build_model(THP(**kw), tb.BertConfig.tiny(**cfg_kw), device="cpu")
    state = model_state_dict_from_flax_params(params, kw["model_name"])
    assert set(state) == set(tmodel.state_dict())
    tmodel.load_state_dict(state)
    return jmodel, params, tmodel


def assert_grads_match(tmodel, name, want_tree):
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in tmodel.named_parameters()}
    got_tree = flax_params_from_model_state_dict(grads, name)
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, want_tree)))
    got = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    assert set(got) == set(want)
    total = np.sqrt(sum(float((w ** 2).sum()) for w in want.values()))
    assert total > 0
    for path, w in want.items():
        scale = max(float(np.linalg.norm(w)), 1e-2 * total)
        err = float(np.abs(got[path] - w).max())
        assert err <= 1e-4 * scale, (jax.tree_util.keystr(path), err, scale)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_train_loss_and_every_gradient_match_jax(rng, name):
    jmodel, params, tmodel = build_pair(name, rng)
    batch = make_batch(rng)
    want, want_grads = jax.value_and_grad(jmodel.train_loss)(
        params, jax.tree.map(jnp.asarray, batch), jax.random.key(1), True)
    got = tmodel.train_loss(to_torch(batch), None, True)
    assert tmodel.training
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    assert_grads_match(tmodel, FAMILIES[name]["model_name"], want_grads)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_in_batch_negatives_with_the_same_permutation(rng, name):
    extra = {}
    if name.startswith("sbalisentbienc") or name == "miswordbienc-l2max":
        extra = dict(cd_svalue_l1_prop=0.01)         # the in-batch-only terms
    jmodel, params, tmodel = build_pair(name, rng, **extra)
    batch = make_batch(rng, neg=False)
    perm = np.array([2, 0, 1])
    jbatch = jax.tree.map(jnp.asarray, batch)
    q_cls, q_sents = jmodel.encode(params, jbatch["query"])
    p_cls, p_sents = jmodel.encode(params, jbatch["pos"])
    if name == "cospecter":
        want = jdm._cls_l2_triplet(q_cls, p_cls, p_cls[perm])
    else:
        n_sents = JMultiVec(embed=p_sents.embed[perm], lens=p_sents.lens[perm])
        want = jmodel._combine_losses(jbatch, q_cls, q_sents, p_cls, p_sents,
                                      p_cls[perm], n_sents, jnp.asarray(perm))
    tbatch = to_torch(batch)
    tmodel.eval()
    reps = tmodel._encode_triple(tbatch, (None, None, None), False)
    got = tmodel._group_loss(tbatch, reps, torch.from_numpy(perm)).sum()
    assert float(got.detach()) == float(tmodel._combine_losses(
        tbatch, *reps[:4], reps[2][perm], None if reps[3] is None else
        TMultiVec(reps[3].embed[perm], reps[3].lens[perm]),
        torch.from_numpy(perm)).detach())
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)


@pytest.mark.parametrize("name", ["sbalisentbienc", "cospecter", "miswordabsbienc"])
def test_grouped_loss_equals_sum_over_micro_batches(rng, name):
    _, _, tmodel = build_pair(name, rng)
    sb = to_torch(make_batch(rng, lead=(3, B), neg=False))
    total, per_group = tmodel.train_loss_grouped(
        sb, torch.Generator().manual_seed(5), True)
    total.backward()
    grouped = {n: p.grad.clone() for n, p in tmodel.named_parameters()
               if p.grad is not None}
    tmodel.zero_grad()
    gen = torch.Generator().manual_seed(5)       # draws the same permutations
    singles = []
    for i in range(3):
        micro = {k: {n: a[i] for n, a in v.items()} for k, v in sb.items()}
        loss = tmodel.train_loss(micro, gen, True)
        loss.backward()
        singles.append(float(loss.detach()))
    np.testing.assert_allclose(per_group.detach().numpy(), singles, rtol=1e-5)
    np.testing.assert_allclose(float(total.detach()), sum(singles), rtol=1e-5)
    total_norm = float(torch.sqrt(sum(g.pow(2).sum() for g in grouped.values())))
    for n, p in tmodel.named_parameters():
        if n in grouped:
            scale = max(float(grouped[n].norm()), 1e-2 * total_norm)
            assert float((p.grad - grouped[n]).abs().max()) <= 1e-4 * scale, n


@pytest.mark.parametrize("name", ["sbalisentbienc", "cospecter"])
def test_grouped_loss_matches_jax_with_explicit_negatives(rng, name):
    jmodel, params, tmodel = build_pair(name, rng)
    sb = make_batch(rng, lead=(2, B), neg=True)
    (want, want_groups), want_grads = jax.value_and_grad(
        jmodel.train_loss_grouped, has_aux=True)(
            params, jax.tree.map(jnp.asarray, sb), jax.random.key(2), True)
    got, got_groups = tmodel.train_loss_grouped(to_torch(sb), None, True)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    np.testing.assert_allclose(got_groups.detach().numpy(),
                               np.asarray(want_groups), rtol=1e-4)
    assert_grads_match(tmodel, FAMILIES[name]["model_name"], want_grads)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_score_reps_match_jax(rng, name):
    jmodel, params, tmodel = build_pair(name, rng)
    d = jb.BertConfig.tiny().hidden_size
    lens_q, lens_c = rng.integers(1, MS + 1, B), rng.integers(1, MS + 1, B)

    def reps(lens):
        emb = rng.standard_normal((B, MS, d)).astype(np.float32)
        emb *= (np.arange(MS)[None, :] < lens[:, None])[:, :, None]
        return rng.standard_normal((B, d)).astype(np.float32), emb

    (q_cls, q_emb), (c_cls, c_emb) = reps(lens_q), reps(lens_c)
    want, _ = jmodel.score_reps(
        jnp.asarray(q_cls), JMultiVec(jnp.asarray(q_emb), jnp.asarray(lens_q)),
        jnp.asarray(c_cls), JMultiVec(jnp.asarray(c_emb), jnp.asarray(lens_c)))
    t = torch.from_numpy
    got, _ = tmodel.score_reps(t(q_cls), TMultiVec(t(q_emb), t(lens_q)),
                               t(c_cls), TMultiVec(t(c_emb), t(lens_c)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_registry_names_and_unknown_model():
    assert set(tdm.MODEL_REGISTRY) == set(jdm.MODEL_REGISTRY)
    for name, cls in tdm.MODEL_REGISTRY.items():
        assert cls.__name__ == jdm.MODEL_REGISTRY[name].__name__
    assert {f.name for f in dataclasses.fields(THP)} \
        == {f.name for f in dataclasses.fields(JHP)}
    with pytest.raises(ValueError, match="Unknown model"):
        tdm.build_model(THP(model_name="nope"), tb.BertConfig.tiny(), device="cpu")


# ---- dropout on: the port's own masks ---------------------------------------
@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_dropout_is_keyed_on_the_generator_seed(rng, impl):
    _, _, tmodel = build_pair("sbalisentbienc", rng, cfg_kw={},
                              attention_impl=impl, hidden_dropout_impl=impl)
    batch = to_torch(make_batch(rng))
    loss = lambda seed: float(tmodel.train_loss(
        batch, torch.Generator().manual_seed(seed), True).detach())
    assert loss(3) == loss(3)
    assert loss(3) != loss(4)
    with pytest.raises(ValueError, match="seed"):
        tmodel.train_loss(batch, None, True)          # dropout needs a generator
    # eval mode: no dropout, no generator needed, no draw taken
    gen = torch.Generator().manual_seed(9)
    state = gen.get_state()
    a = float(tmodel.train_loss(batch, gen, False).detach())
    assert not tmodel.training
    assert torch.equal(gen.get_state(), state)
    assert a == float(tmodel.train_loss(batch, None, False).detach())


def test_naive_and_fused_routes_draw_the_same_masks(rng):
    kw = dict(cfg_kw={})
    _, _, naive = build_pair("sbalisentbienc", np.random.default_rng(1),
                             attention_impl="naive", hidden_dropout_impl="naive",
                             ffn_impl="naive", **kw)
    _, _, fused = build_pair("sbalisentbienc", np.random.default_rng(1),
                             attention_impl="fused", hidden_dropout_impl="fused",
                             ffn_impl="naive", **kw)
    batch = to_torch(make_batch(rng))
    a = naive.train_loss(batch, torch.Generator().manual_seed(3), True)
    b = fused.train_loss(batch, torch.Generator().manual_seed(3), True)
    assert float(a.detach()) == float(b.detach())


def test_embedding_dropout_keep_rate_and_eval_identity(rng):
    cfg = tb.BertConfig.tiny(hidden_dropout_prob=0.25, hidden_size=64,
                             max_position_embeddings=128)
    emb = tb.BertEmbeddings(cfg, device="cpu")
    tok = torch.from_numpy(rng.integers(5, 128, (8, 128)))
    typ = torch.zeros_like(tok)
    emb.train()
    out = emb(tok, typ, seed=21)
    zero = float((out == 0).float().mean())
    assert abs(zero - 0.25) < 0.01                    # 65k draws
    emb.eval()
    ref = emb(tok, typ)
    assert float((ref == 0).float().mean()) == 0.0
    kept = out != 0
    np.testing.assert_allclose(out[kept].detach().numpy(),
                               (ref[kept] / 0.75).detach().numpy(), rtol=1e-6)
