"""Port parity: models/sent_models.py (cosentbert, ictsentbert) against the
JAX package: training loss and the gradient of every parameter on bridged
weights and the same numpy batch, float32, dropout probabilities 0 and
train=True.  Tolerances as in test_torch_doc_models.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.core.config import ModelHParams as JHP
from aspire_tpu.models import bert as jb
from aspire_tpu.models import doc_models as jdm
from aspire_tpu_torch.core.config import ModelHParams as THP
from aspire_tpu_torch.models import bert as tb
from aspire_tpu_torch.models import doc_models as tdm
from aspire_tpu_torch.models.sent_models import ICTModel, SentTripleModel

from test_torch_doc_models import (NO_DROP, T, assert_grads_match, make_batch,
                                   to_torch)
from aspire_tpu_torch.models.convert import model_state_dict_from_flax_params


def build_pair(name, rng, cfg_kw=NO_DROP):
    jmodel = jdm.build_model(JHP(model_name=name), jb.BertConfig.tiny(**cfg_kw))
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        jmodel.init_params(jax.random.key(0), seq_len=T))
    tmodel = tdm.build_model(THP(model_name=name), tb.BertConfig.tiny(**cfg_kw),
                             device="cpu")
    state = model_state_dict_from_flax_params(params, name)
    assert set(state) == set(tmodel.state_dict())
    tmodel.load_state_dict(state)
    return jmodel, params, tmodel


@pytest.mark.parametrize("name,neg", [("cosentbert", True), ("ictsentbert", False)])
def test_train_loss_and_every_gradient_match_jax(rng, name, neg):
    jmodel, params, tmodel = build_pair(name, rng)
    assert isinstance(tmodel, {"cosentbert": SentTripleModel,
                               "ictsentbert": ICTModel}[name])
    batch = make_batch(rng, neg=neg)
    want, want_grads = jax.value_and_grad(jmodel.train_loss)(
        params, jax.tree.map(jnp.asarray, batch), jax.random.key(1), True)
    got = tmodel.train_loss(to_torch(batch), None, True)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    assert_grads_match(tmodel, name, want_grads)


def test_ict_towers_are_two_encoders(rng):
    _, params, tmodel = build_pair("ictsentbert", rng)
    assert set(params) == {"sent", "context"}
    names = {n.split(".")[0] for n in tmodel.state_dict()}
    assert names == {"sent_encoder", "context_encoder"}
    batch = to_torch(make_batch(rng, neg=False))
    tmodel.eval()
    cls, none = tmodel.encode(batch["query"])
    assert none is None and cls.shape == (3, 32)


def test_cosentbert_in_batch_negatives_follow_the_generator(rng):
    _, _, tmodel = build_pair("cosentbert", rng)
    batch = to_torch(make_batch(rng, neg=False))
    loss = lambda seed: float(tmodel.train_loss(
        batch, torch.Generator().manual_seed(seed), True).detach())
    assert loss(1) == loss(1)
    with pytest.raises(ValueError, match="Generator"):
        tmodel.train_loss(batch, None, True)
    gen = torch.Generator().manual_seed(1)
    torch.randint(0, 2 ** 63 - 1, (3,), generator=gen, dtype=torch.int64)
    perm = torch.randperm(3, generator=gen)
    q, _ = tmodel.encode(batch["query"])
    p, _ = tmodel.encode(batch["pos"])
    want = tdm._cls_l2_triplet(q, p, p[perm])
    np.testing.assert_allclose(loss(1), float(want.detach()), rtol=1e-6)


@pytest.mark.parametrize("name", ["cosentbert", "ictsentbert"])
def test_dropout_on_needs_and_follows_the_seed(rng, name):
    _, _, tmodel = build_pair(name, rng, cfg_kw={})
    batch = to_torch(make_batch(rng, neg=True))
    loss = lambda seed: float(tmodel.train_loss(
        batch, torch.Generator().manual_seed(seed), True).detach())
    assert loss(2) == loss(2) and loss(2) != loss(3)
    eval_loss = float(tmodel.train_loss(batch, None, False).detach())
    assert eval_loss == float(tmodel.train_loss(batch, None, False).detach())
