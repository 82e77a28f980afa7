"""Port parity: train/schedules.py, train/trainer.py, train/predict_utils.py
and utils/checkpoint.py.

Schedules: point by point against the JAX package's optax schedules.
Trainer: three optimizer steps from the same bridged weights on the same
numpy superbatches (explicit negatives, dropout probabilities 0) against the
JAX Trainer's jitted step, parameters within 1e-5 -- a tenth of one Adam step
at the learning rate used.  Adam divides by |g|, so where a gradient is zero up
to rounding (a softmax's shared key bias, the last LayerNorm's bias under a
loss of differences) its sign noise becomes a full step: entries whose first
JAX gradient is below 1e-6 are held to the reach of 3 steps a side instead.
"""
import json
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.core.config import (ModelHParams as JHP, RunConfig as JRC,
                                    TrainHParams as JTP)
from aspire_tpu.models import bert as jb
from aspire_tpu.models import doc_models as jdm
from aspire_tpu.parallel.mesh import make_mesh
from aspire_tpu.train import trainer as jtr
from aspire_tpu.train.schedules import build_schedule as jax_schedule
from aspire_tpu_torch.core.config import (ModelHParams as THP, RunConfig as TRC,
                                          TrainHParams as TTP)
from aspire_tpu_torch.models import bert as tb
from aspire_tpu_torch.models import doc_models as tdm
from aspire_tpu_torch.models.convert import (flax_params_from_model_state_dict,
                                             model_state_dict_from_flax_params)
from aspire_tpu_torch.train.predict_utils import batched_f1, batched_loss
from aspire_tpu_torch.train.schedules import build_schedule, total_micro_iters
from aspire_tpu_torch.train.trainer import Trainer, TrainState
from aspire_tpu_torch.utils.checkpoint import restore_params

from test_torch_doc_models import B, MS, NO_DROP, T, make_batch, to_torch

HP = dict(model_name="sbalisentbienc", score_aggregation="l2max",
          sent_loss_prop=1.0, sentsup_loss_prop=1.0, abs_loss_prop=0.5,
          max_sents=MS)


# ------------------------------------------------------------- schedules ----
@pytest.mark.parametrize("kw", [
    dict(lr_decay_method="warmuplin", num_warmup_steps=7, train_size=90),
    dict(lr_decay_method="warmuplin", num_warmup_steps=0, train_size=9),
    dict(lr_decay_method="warmuplin", num_warmup_steps=50, train_size=30),
    dict(lr_decay_method="warmupcosine", num_warmup_steps=5, train_size=60),
    dict(lr_decay_method="exponential", decay_lr_every=4, decay_lr_by=0.9),
], ids=["warmuplin", "warmuplin-no-warmup", "warmuplin-long-warmup",
        "warmupcosine", "exponential"])
def test_schedules_match_optax_point_by_point(kw):
    kw = dict(kw, learning_rate=3e-4, batch_size=3, num_epochs=2)
    want_fn, got_fn = jax_schedule(JTP(**kw)), build_schedule(TTP(**kw))
    assert total_micro_iters(TTP(**kw)) == max(1, -(-kw.get("train_size", 0) // 3)) * 2
    for count in list(range(0, 80)) + [200, 1000]:
        np.testing.assert_allclose(got_fn(count), float(want_fn(count)),
                                   rtol=1e-5, atol=1e-12, err_msg=str(count))   # optax works in f32


def test_unknown_schedule_and_update_rule_raise(tmp_path):
    with pytest.raises(ValueError, match="lr_decay_method"):
        build_schedule(TTP(lr_decay_method="nope"))
    model = tdm.build_model(THP(**HP), tb.BertConfig.tiny(), device="cpu")
    with pytest.raises(ValueError, match="update rule"):
        Trainer(model, TRC(THP(**HP), TTP(update_rule="sgd")), str(tmp_path))


# ---------------------------------------------------------------- helpers ----
def pair(rng, tp_kw, hp_kw=HP, cfg_kw=NO_DROP):
    jmodel = jdm.build_model(JHP(**hp_kw), jb.BertConfig.tiny(**cfg_kw))
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        jmodel.init_params(jax.random.key(0), seq_len=T))
    tmodel = tdm.build_model(THP(**hp_kw), tb.BertConfig.tiny(**cfg_kw),
                             device="cpu")
    tmodel.load_state_dict(model_state_dict_from_flax_params(
        params, hp_kw["model_name"]))
    return jmodel, params, tmodel, JRC(JHP(**hp_kw), JTP(**tp_kw)), \
        TRC(THP(**hp_kw), TTP(**tp_kw))


def port_model(rng, hp_kw=HP, cfg_kw=NO_DROP):
    """A port model with every weight from the numpy generator (PyTorch's own
    initialisers draw from the global generator)."""
    model = tdm.build_model(THP(**hp_kw), tb.BertConfig.tiny(**cfg_kw),
                            device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            base = 1.0 if name.endswith("LayerNorm.weight") else 0.0
            p.copy_(torch.from_numpy(base + 0.05 * rng.standard_normal(
                tuple(p.shape)).astype(np.float32)))
    return model


TP = dict(batch_size=B, accumulated_batch_size=2 * B, learning_rate=1e-4,
          num_warmup_steps=2, train_size=60, es_check_every=4)


# ------------------------------------------------ three steps against JAX ----
@pytest.mark.parametrize("rule,fused", [("adam", True), ("adagrad", False)])
def test_three_optimizer_steps_match_the_jax_trainer(rng, tmp_path, rule, fused):
    lr = 1e-4 if rule == "adam" else 1e-2
    tp_kw = dict(TP, update_rule=rule, learning_rate=lr)
    jmodel, params, tmodel, jrc, trc = pair(rng, tp_kw)
    steps = [make_batch(rng, lead=(2, B), neg=True) for _ in range(3)]

    jtrainer = jtr.Trainer(jmodel, jrc, str(tmp_path / "jax"),
                           mesh=make_mesh(n_data=1), early_stop=False,
                           fused_accum=fused)
    first_grads = jax.grad(lambda p: jmodel.train_loss_grouped(
        p, jax.tree.map(jnp.asarray, steps[0]), jax.random.key(0), True)[0])(params)
    jparams = jax.tree.map(jnp.asarray, params)
    state = jtr.TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                           opt_state=jtrainer.optimizer.init(jparams))
    jax_losses = []
    for sb in steps:
        state, losses = jtrainer._train_step(
            state, jax.tree.map(jnp.asarray, sb), jax.random.key(0))
        jax_losses.append(np.asarray(losses))
    jtrainer.close()

    trainer = Trainer(tmodel, trc, str(tmp_path / "torch"), early_stop=False,
                      fused_accum=fused)
    tstate = trainer.init_state()
    got_losses = [trainer.train_step(tstate, to_torch(sb), None).numpy()
                  for sb in steps]
    trainer.close()
    assert tstate.step == 3 and int(state.step) == 3
    np.testing.assert_allclose(np.stack(got_losses), np.stack(jax_losses),
                               rtol=1e-4)

    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, state.params)))
    got = dict(jax.tree_util.tree_leaves_with_path(
        flax_params_from_model_state_dict(tmodel.state_dict(), HP["model_name"])))
    start = dict(jax.tree_util.tree_leaves_with_path(params))
    g0 = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, first_grads)))
    moved = 0.0
    for path, w in want.items():
        err = np.abs(got[path] - w)
        noisy = (np.abs(g0[path]) < 1e-6) if rule == "adam" \
            else np.zeros_like(w, bool)
        assert float(err[~noisy].max(initial=0.0)) <= 1e-5, jax.tree_util.keystr(path)
        assert float(err[noisy].max(initial=0.0)) <= 6 * lr, jax.tree_util.keystr(path)
        moved = max(moved, float(np.abs(w - start[path]).max()))
    assert moved > 10 * 1e-5          # the steps moved far more than the tolerance


def test_first_update_runs_at_schedule_zero(rng, tmp_path):
    """optax reads schedule(count) with count the updates already taken: under
    warmuplin the first update has lr 0 and moves nothing."""
    model = port_model(rng)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(model, TRC(THP(**HP), TTP(**dict(TP, num_warmup_steps=4))),
                      str(tmp_path), fused_accum=True)
    state = trainer.init_state()
    lrs = [state.scheduler.get_last_lr()[0]]
    sb = to_torch(make_batch(rng, lead=(2, B), neg=True))
    trainer.train_step(state, sb, None)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    lrs.append(state.scheduler.get_last_lr()[0])
    trainer.train_step(state, sb, None)
    assert not all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    lrs.append(state.scheduler.get_last_lr()[0])
    # update k runs at schedule(k * update_every), update_every = 2
    sched = build_schedule(trainer.tp)
    assert lrs == [sched(0), sched(2), sched(4)] and lrs[0] == 0.0
    assert trainer.update_every == 2


def test_adagrad_starts_as_optax_does(rng, tmp_path):
    model = port_model(rng)
    trainer = Trainer(model, TRC(THP(**HP), TTP(**dict(TP, update_rule="adagrad"))),
                      str(tmp_path))
    group = trainer.init_state().optimizer.param_groups[0]
    assert group["initial_accumulator_value"] == 0.1 and group["eps"] == 1e-7


# --------------------------------------------------------- the port alone ----
def test_sequential_and_fused_accumulation_take_the_same_step(rng, tmp_path):
    sb = to_torch(make_batch(rng, lead=(2, B), neg=False))
    out = []
    for fused in (True, False):
        model = port_model(np.random.default_rng(3))
        # Adagrad: smooth in the gradient, unlike Adam's g / |g| (see above)
        tp = TTP(**dict(TP, num_warmup_steps=0, update_rule="adagrad",
                        learning_rate=1e-2))
        trainer = Trainer(model, TRC(THP(**HP), tp), str(tmp_path / str(fused)),
                          fused_accum=fused)
        state = trainer.init_state()
        for _ in range(3):
            losses = trainer.train_step(state, sb, torch.Generator().manual_seed(1))
        out.append((losses, model.state_dict()))
    np.testing.assert_allclose(out[0][0].numpy(), out[1][0].numpy(), rtol=1e-5)
    for k, v in out[0][1].items():
        np.testing.assert_allclose(v.numpy(), out[1][1][k].numpy(), atol=2e-6,
                                   err_msg=k)


def test_non_finite_loss_suppresses_the_update(rng, tmp_path):
    model = port_model(rng)
    trainer = Trainer(model, TRC(THP(**HP), TTP(**dict(TP, num_warmup_steps=0))),
                      str(tmp_path), fused_accum=True)
    state = trainer.init_state()
    sb = to_torch(make_batch(rng, lead=(2, B), neg=True))
    trainer.train_step(state, sb, None)                 # moments now non-zero
    params = {k: v.clone() for k, v in model.state_dict().items()}
    opt = json.dumps(state.optimizer.state_dict(), default=lambda t: t.tolist())
    epoch = state.scheduler.last_epoch
    good = model.train_loss_grouped
    model.train_loss_grouped = lambda *a: tuple(
        x * float("nan") for x in good(*a))
    losses = trainer.train_step(state, sb, None)
    assert not bool(torch.isfinite(losses).any())
    assert state.step == 1 and state.scheduler.last_epoch == epoch
    assert all(torch.equal(params[k], v) for k, v in model.state_dict().items())
    assert opt == json.dumps(state.optimizer.state_dict(),
                             default=lambda t: t.tolist())
    model.train_loss_grouped = good
    trainer.train_step(state, sb, None)
    assert state.step == 2


def test_train_loop_dev_checks_checkpoints_and_run_wide_best(rng, tmp_path):
    model = port_model(rng)
    trc = TRC(THP(**HP), TTP(**dict(TP, num_warmup_steps=0)))
    trainer = Trainer(model, trc, str(tmp_path), fused_accum=True)
    state = trainer.init_state()
    batches = [make_batch(rng, lead=(2, B), neg=False) for _ in range(4)]
    dev = [make_batch(rng, neg=True) for _ in range(2)]
    state = trainer.train(state, batches, lambda: iter(dev), seed=3)
    # 4 steps of 2 micro iterations, a dev check every 4 micro iterations
    assert state.step == 4 and trainer.dev_checked_iters == [4, 8]
    assert trainer.best_score == max(trainer.dev_score_history)
    assert len(trainer.loss_history) == 2 and trainer.loss_checked_iters == [0, 1]
    for name in ("model_cur_best.pt", "model_final.pt", "run_info.json",
                 "metrics.jsonl"):
        assert (tmp_path / name).exists(), name
    kinds = [json.loads(l)["kind"] for l in (tmp_path / "metrics.jsonl").open()]
    assert kinds.count("dev_score") == 2 and "train_loss" in kinds
    final = restore_params(tmp_path / "model_final.pt")
    assert all(v.device.type == "cpu" for v in final.values())
    assert all(torch.equal(final[k], v) for k, v in model.state_dict().items())
    assert set(trainer.load_checkpoint("cur_best")) == set(final)
    # the dev score is -batched_loss over the same stream
    np.testing.assert_allclose(trainer.dev_score(state, iter(dev)),
                               -batched_loss(model, iter(dev)), rtol=1e-6)
    # a later call with a worse score must not overwrite the run-wide best
    trainer.best_score = 1e9
    best_bytes = (tmp_path / "model_cur_best.pt").read_bytes()
    state = trainer.train(state, batches[:2], lambda: iter(dev), seed=4)
    assert trainer.best_score == 1e9 and state.step == 6
    assert (tmp_path / "model_cur_best.pt").read_bytes() == best_bytes
    assert not all(torch.equal(final[k], v)
                   for k, v in restore_params(tmp_path / "model_final.pt").items())
    with pytest.raises(ValueError, match="re-iterable"):
        trainer.train(state, iter(batches), epochs=2)


def test_no_dev_checks_makes_final_the_best(rng, tmp_path):
    model = port_model(rng)
    trainer = Trainer(model, TRC(THP(**HP), TTP(**TP)), str(tmp_path),
                      early_stop=False)
    state = trainer.train(trainer.init_state(),
                          [make_batch(rng, lead=(2, B), neg=True)])
    assert trainer.best_score == -math.inf and state.step == 1
    a = restore_params(tmp_path / "model_final.pt")
    b = restore_params(tmp_path / "model_cur_best.pt")
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_run_info_json_equals_the_jax_package(tmp_path):
    kw_m = dict(HP, sent_sm_temp=5000.0, geoml_reach=None)
    kw_t = dict(TP, update_rule="adagrad")
    extra = {"note": "x"}
    JRC(JHP(**kw_m), JTP(**kw_t), extra).to_run_info(tmp_path / "jax.json")
    TRC(THP(**kw_m), TTP(**kw_t), extra).to_run_info(tmp_path / "torch.json")
    assert (tmp_path / "jax.json").read_text() == (tmp_path / "torch.json").read_text()
    back = TRC.from_run_info(tmp_path / "jax.json")
    assert back.model == THP(**kw_m) and back.train == TTP(**kw_t)
    assert back.extra == extra
    assert TRC.from_dict({"base-pt-layer": "x"}).model.base_pt_layer == "x"


def test_resume_gives_the_same_next_step(rng, tmp_path):
    """With dropout on: the full state (model, moments, schedule, step) and
    the same generator seed reproduce the third step exactly."""
    batches = [make_batch(rng, lead=(2, B), neg=False) for _ in range(3)]
    trc = TRC(THP(**HP), TTP(**dict(TP, num_warmup_steps=3)))
    model = port_model(np.random.default_rng(5), cfg_kw={})
    trainer = Trainer(model, trc, str(tmp_path), fused_accum=True)
    state = trainer.train(trainer.init_state(), batches[:2], seed=1)
    trainer.save_full_state(state)
    trainer.best_score = -3.5
    trainer.save_full_state(state, "other")
    state = trainer.train(state, batches[2:], seed=2)
    assert state.step == 3

    model2 = port_model(np.random.default_rng(6), cfg_kw={})     # other weights
    resumed = Trainer(model2, trc, str(tmp_path), fused_accum=True)
    state2 = resumed.restore_full_state()
    assert isinstance(state2, TrainState) and state2.step == 2
    assert resumed._micro_iter == 4 and resumed.best_score == -math.inf
    assert state2.scheduler.get_last_lr() == [build_schedule(trc.train)(4)]
    state2 = resumed.train(state2, batches[2:], seed=2)
    assert state2.step == 3
    for k, v in model.state_dict().items():
        assert torch.equal(v, model2.state_dict()[k]), k
    assert resumed.restore_full_state("other").step == 2
    assert resumed.best_score == -3.5


def test_batched_f1():
    batches = [{"labels": np.array([1, 0, 1])}, {"labels": np.array([0, 1])}]
    logits = iter([torch.tensor([[0.1, 0.9], [0.8, 0.2], [0.7, 0.3]]),
                   np.array([[0.9, 0.1], [0.2, 0.8]])])
    # predictions 1 0 0 | 0 1 against 1 0 1 | 0 1: precision 1, recall 2/3
    assert batched_f1(lambda batch: next(logits), batches) == pytest.approx(0.8)
