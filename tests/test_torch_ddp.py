"""Data-parallel training: the port's gloo ranks against one process and
against the JAX package's two-device mesh.

The ranks are spawned once for the file (`ranks`).  Each runs:

  * three optimizer steps of sbalisentbienc (OT distance, sentence
    supervision, CLS triplet, the in-batch singular-value term) at
    BertConfig.tiny() with dropout 0.1 and in-batch negatives, through the
    sequential path and through the fused one, as Trainer(mesh=) takes them;
  * the same model's training encode of its rows with their philox.Seed;
  * the loss and gradient at dropout 0 with a given permutation, for the
    JAX package's two-device mesh.

Held as tests/test_dp_parity.py holds the JAX package's own data-parallel
step: losses within 2e-4, parameters within 5e-4 (Adam divides tiny
gradients by their root mean square, which amplifies the reduction order);
the ranks' parameters equal bit for bit.  The masks of a rank are the
one-process masks' rows bit for bit.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.core.config import ModelHParams as JHP
from aspire_tpu.core.types import MultiVec as JMultiVec
from aspire_tpu.models import bert as jb
from aspire_tpu.models import doc_models as jdm
from aspire_tpu.parallel.mesh import make_mesh as jax_make_mesh
from aspire_tpu.parallel.mesh import replicate as jax_replicate
from aspire_tpu.parallel.mesh import shard_batch as jax_shard_batch
from aspire_tpu_torch.core.config import (ModelHParams as THP, RunConfig as TRC,
                                          TrainHParams as TTP)
from aspire_tpu_torch.models import bert as tb
from aspire_tpu_torch.models import doc_models as tdm
from aspire_tpu_torch.models.convert import model_state_dict_from_flax_params
from aspire_tpu_torch.ops import attention_kernel as ak
from aspire_tpu_torch.ops import dropout_kernel as dk
from aspire_tpu_torch.ops.philox import Seed
from aspire_tpu_torch.parallel import mesh as pm
from aspire_tpu_torch.train.trainer import Trainer

from test_torch_doc_models import (FAMILIES, NO_DROP, T, assert_grads_match,
                                   make_batch, to_torch)

WORLD, N_MICRO, MICRO, STEPS = 2, 2, 4, 3
NAME = "sbalisentbienc"
HP = dict(FAMILIES[NAME], max_sents=4, cd_svalue_l1_prop=0.01)
TP = dict(train_size=24, batch_size=MICRO, accumulated_batch_size=MICRO * N_MICRO,
          learning_rate=1e-4, num_warmup_steps=2, es_check_every=100)
DROP = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
PERM = np.array([2, 0, 3, 1])


def _data():
    rng = np.random.default_rng(21)
    batches = [make_batch(rng, lead=(N_MICRO, MICRO), neg=False)
               for _ in range(STEPS)]
    jmodel = jdm.build_model(JHP(**HP), jb.BertConfig.tiny(**NO_DROP))
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(
            np.float32), jmodel.init_params(jax.random.key(0), seq_len=T))
    state = {k: v.numpy() for k, v in
             model_state_dict_from_flax_params(params, NAME).items()}
    grad_batch = make_batch(rng, lead=(MICRO,), neg=False)
    return dict(batches=batches, params=params, state=state,
                grad_batch=grad_batch)


def _model(state, drop: bool):
    model = tdm.build_model(THP(**HP), tb.BertConfig.tiny(**(DROP if drop else
                                                            NO_DROP)),
                            device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def _train(data, fused: bool, path, mesh=None):
    """Three steps; -> (losses [STEPS, N_MICRO], final parameters)."""
    model = _model(data["state"], drop=True)
    trainer = Trainer(model, TRC(THP(**HP), TTP(**TP)), path,
                      early_stop=False, fused_accum=fused, mesh=mesh)
    state = trainer.init_state()
    rng = torch.Generator().manual_seed(7)
    losses = [trainer.train_step(state, trainer.place(sb), rng, N_MICRO).numpy()
              for sb in data["batches"]]
    params = {k: v.detach().numpy().copy()
              for k, v in model.state_dict().items()}
    return np.stack(losses), params


def _encode_rows(data, mesh=None):
    """The training encode (dropout 0.1) of the first superbatch's queries."""
    model = _model(data["state"], drop=True)
    feats = {k: v[0] for k, v in data["batches"][0]["query"].items()}
    layout = tdm.Layout.of(MICRO // (1 if mesh is None else WORLD), mesh)
    if mesh is not None:
        feats = pm.shard_batch(feats, mesh)
    model.train()
    with torch.no_grad():
        cls, sents = model.encode(to_torch(feats), seed=layout.seed(1234))
    return cls.numpy(), sents.embed.numpy()


def _loss_and_grads(data, mesh):
    """Loss and gradient at dropout 0 with the permutation PERM."""
    model = _model(data["state"], drop=False)
    tdm.draw_step_rng = lambda rng, b, need: ((None,) * 3,
                                              torch.from_numpy(PERM))
    batch = pm.shard_batch(to_torch(data["grad_batch"]), mesh)
    loss = model.train_loss(batch, None, True, mesh=mesh)
    loss.backward()
    trainer = Trainer(model, TRC(THP(**HP), TTP(**TP)), data["path"] + "/g",
                      mesh=mesh)
    trainer._sum_grads(torch.optim.SGD(model.parameters(), lr=0.0))
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()
             if p.grad is not None}
    return float(pm.all_reduce(loss.detach(), mesh)), grads


def _rank(data):
    mesh = pm.make_mesh(WORLD)
    out = {f"train_{fused}": _train(data, fused, data["path"] + f"/{fused}",
                                    mesh) for fused in (False, True)}
    out["encode"] = _encode_rows(data, mesh)
    out["grad"] = _loss_and_grads(data, mesh)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    data = _data()
    data["path"] = str(tmp_path_factory.mktemp("ddp"))
    results = pm.run_ranks(_rank, WORLD, {k: v for k, v in data.items()
                                          if k != "params"}, device="cpu")
    return data, results


@pytest.mark.parametrize("fused", [False, True])
def test_ranks_match_one_process(ranks, fused, tmp_path):
    data, results = ranks
    want_losses, want_params = _train(data, fused, str(tmp_path))
    for r in results:
        got_losses, got_params = r[f"train_{fused}"]
        np.testing.assert_allclose(got_losses, want_losses, rtol=2e-4,
                                   atol=2e-4)
        assert got_params.keys() == want_params.keys()
        for k in want_params:
            np.testing.assert_allclose(got_params[k], want_params[k],
                                       rtol=5e-4, atol=5e-4, err_msg=k)
    # the update really moved the parameters
    assert any(not np.array_equal(want_params[k], data["state"][k])
               for k in want_params)


@pytest.mark.parametrize("fused", [False, True])
def test_ranks_hold_the_same_parameters(ranks, fused):
    _, results = ranks
    losses0, params0 = results[0][f"train_{fused}"]
    for r in results[1:]:
        losses, params = r[f"train_{fused}"]
        np.testing.assert_array_equal(losses, losses0)
        for k in params0:
            np.testing.assert_array_equal(params[k], params0[k], err_msg=k)


def test_rank_encodes_are_rows_of_the_one_process_encode(ranks):
    data, results = ranks
    cls, sents = _encode_rows(data)
    rows = MICRO // WORLD
    for r, res in enumerate(results):
        got_cls, got_sents = res["encode"]
        np.testing.assert_allclose(got_cls, cls[r * rows:(r + 1) * rows],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_sents, sents[r * rows:(r + 1) * rows],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rows,h", [(48, 32), (7, 16)])
def test_hidden_masks_of_a_rank_are_rows_of_the_global_mask(rows, h):
    whole = dk.keep_mask((4 * rows, h), 0.1, seed=99, site=3)
    for r in range(4):
        part = dk.keep_mask((rows, h), 0.1, seed=99, site=3, row0=r * rows)
        assert torch.equal(part, whole[r * rows:(r + 1) * rows])
    assert torch.equal(dk.keep_mask((rows, h), 0.1, seed=99, site=3, row0=0),
                       whole[:rows])


def test_attention_masks_of_a_rank_are_planes_of_the_global_mask():
    b, nh, t = 6, 4, 20
    whole = ak.attention_keep_mask((b, nh, t, 8), 0.1, seed=5, site=1)
    for r in range(3):
        part = ak.attention_keep_mask((2, nh, t, 8), 0.1, seed=5, site=1,
                                      plane0=2 * r * nh)
        assert torch.equal(part, whole[2 * r:2 * r + 2])


def test_bert_dropout_of_a_rank_is_rows_of_the_one_process_dropout():
    """A Seed's example offset reaches both dropout kinds through the BERT
    encoder: the plain route's masks, bit for bit, give the rows' outputs."""
    torch.manual_seed(0)
    model = tb.BertModel(tb.BertConfig.tiny(**DROP), device="cpu",
                         attention_impl="naive", hidden_dropout_impl="naive")
    model.train()
    ids = torch.randint(5, 100, (4, 12))
    mask = torch.ones_like(ids)
    with torch.no_grad():
        whole, _ = model(ids, mask, seed=77)
        for r in range(2):
            part, _ = model(ids[2 * r:2 * r + 2], mask[2 * r:2 * r + 2],
                            seed=Seed(77, 2 * r))
            np.testing.assert_allclose(part.numpy(),
                                       whole[2 * r:2 * r + 2].numpy(),
                                       rtol=1e-5, atol=1e-6)
        other, _ = model(ids[2:], mask[2:], seed=77)
    assert not torch.allclose(other, whole[2:])


def test_ranks_match_the_jax_two_device_mesh(ranks):
    data, results = ranks
    jmodel = jdm.build_model(JHP(**HP), jb.BertConfig.tiny(**NO_DROP))
    mesh = jax_make_mesh(n_data=WORLD)
    perm = jnp.asarray(PERM)

    def loss(params, batch):
        q_cls, q_sents = jmodel.encode(params, batch["query"])
        p_cls, p_sents = jmodel.encode(params, batch["pos"])
        n_sents = JMultiVec(embed=p_sents.embed[perm], lens=p_sents.lens[perm])
        return jmodel._combine_losses(batch, q_cls, q_sents, p_cls, p_sents,
                                      p_cls[perm], n_sents, perm)

    batch = jax_shard_batch(jax.tree.map(jnp.asarray, data["grad_batch"]), mesh)
    params = jax_replicate(jax.tree.map(jnp.asarray, data["params"]), mesh)
    want, want_grads = jax.jit(jax.value_and_grad(loss))(params, batch)
    for r in results:
        got, grads = r["grad"]
        np.testing.assert_allclose(got, float(want), rtol=1e-4)
        model = _model(data["state"], drop=False)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n]) if n in grads else None
        assert_grads_match(model, NAME, want_grads)


def test_micro_batch_must_split_over_the_ranks(tmp_path):
    class Two:
        def size(self, axis):
            return 3
    with pytest.raises(ValueError, match="does not split"):
        Trainer(_model(_data()["state"], drop=False),
                TRC(THP(**HP), TTP(**TP)), str(tmp_path), mesh=Two())
