"""Pool-restricted ranking (make_pool_rank_batched, all four aggregations, and
make_cls_pool_rank_batched): the port against the JAX package."""
import ml_dtypes
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.index import cls as jcls
from aspire_tpu.index import dense as jdense
from aspire_tpu.index import serve as jserve
from aspire_tpu_torch.index import cls as tcls
from aspire_tpu_torch.index import dense as tdense
from aspire_tpu_torch.index import serve as tserve

DIM, MS = 16, 10
JDT = {"bfloat16": ml_dtypes.bfloat16, "float32": np.float32, "int8": "int8"}


def _setup(rng, dtype, unit=False, n_docs=30, bsz=3, qmax=8, pool=16):
    reps = [rng.normal(size=(int(rng.integers(1, MS)), DIM)).astype(np.float32)
            for _ in range(n_docs)]
    if unit:
        reps = [r / np.linalg.norm(r, axis=1, keepdims=True) for r in reps]
    pids = [f"p{i}" for i in range(n_docs)]
    score_type = "cosine" if unit else "l2"
    j = jdense.build_dense_index(reps, pids, dtype=JDT[dtype], score_type=score_type)
    t = tdense.build_dense_index(reps, pids, dtype=dtype, score_type=score_type)
    q = rng.normal(size=(bsz, qmax, DIM)).astype(np.float32)
    if unit:
        q /= np.linalg.norm(q, axis=2, keepdims=True)
    q_lens = rng.integers(1, qmax + 1, bsz).astype(np.int32)
    cand_ids = np.full((bsz, pool), -1, np.int32)
    for i in range(bsz):
        q[i, q_lens[i]:] = 0
        n = int(rng.integers(3, pool + 1))
        cand_ids[i, :n] = rng.choice(n_docs, n, replace=False)
    jargs = (*jdense.flatten_device_buckets(j.device_arrays()),
             *j.device_pos_arrays())
    targs = (*tdense.flatten_device_buckets(t.device_arrays("cpu")),
             *t.device_pos_arrays("cpu"))
    return j, t, q, q_lens, cand_ids, jargs, targs


@pytest.mark.parametrize("agg,dtype,j_solver,t_solver", [
    ("ot", "float32", "xla", "torch"), ("ot", "float32", "pallas", "kernel"),
    ("ot", "int8", "xla", "torch"), ("ot", "bfloat16", "pallas", "kernel"),
    ("l2max", "float32", "xla", "torch"), ("l2max", "int8", "xla", "torch"),
    ("jointsm", "float32", "xla", "torch"), ("jointsm", "bfloat16", "xla", "torch"),
    ("cosine_max", "float32", "xla", "torch")])
def test_pool_rank_matches_jax(rng, agg, dtype, j_solver, t_solver):
    unit = agg == "cosine_max"
    j, t, q, q_lens, cand_ids, jargs, targs = _setup(rng, dtype, unit)
    kw = dict(pool_size=16, max_sents=MS, agg=agg, int8=dtype == "int8",
              temp=5.0, score_type="cosine" if unit else "l2")
    want = np.asarray(jserve.make_pool_rank_batched(
        len(j.buckets), solver=j_solver, **kw)(
        jnp.asarray(q), jnp.asarray(q_lens), jnp.asarray(cand_ids), *jargs))
    tq, tl, tc = (torch.from_numpy(a) for a in (q, q_lens, cand_ids))
    got = tserve.make_pool_rank_batched(len(t.buckets), solver=t_solver, **kw)(
        tq, tl, tc, *targs).numpy()
    pad = cand_ids < 0
    assert (got[pad] == np.float32(-1e30)).all() and (want[pad] < -1e29).all()
    tol = dict(rtol=2e-3, atol=2e-3) if agg == "ot" else dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[~pad], want[~pad], **tol)
    # a pair's score does not depend on what it is batched with
    one = tserve.make_pool_rank_batched(len(t.buckets), solver=t_solver,
                                        rerank_chunk=1, **kw)(tq, tl, tc, *targs)
    np.testing.assert_allclose(one.numpy()[~pad], got[~pad], rtol=1e-5, atol=1e-5)


def test_pool_rank_refuses_wrong_settings(rng):
    _, t, q, q_lens, cand_ids, _, targs = _setup(rng, "float32")
    with pytest.raises(ValueError, match="cosine_max"):
        tserve.make_pool_rank_batched(len(t.buckets), 16, MS, agg="cosine_max")
    with pytest.raises(ValueError, match="unknown pool agg"):
        tserve.make_pool_rank_batched(len(t.buckets), 16, MS, agg="dot")
    fn = tserve.make_pool_rank_batched(len(t.buckets), 8, MS, agg="l2max")
    with pytest.raises(ValueError, match="pools of 8"):
        fn(torch.from_numpy(q), torch.from_numpy(q_lens),
           torch.from_numpy(cand_ids), *targs)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cls_pool_rank_matches_jax(rng, dtype):
    n, d, bsz, pool = 37, 16, 3, 9
    reps = rng.normal(size=(n, d)).astype(np.float32)
    j = jcls.build_cls_index(reps, list(range(n)), dtype=JDT[dtype])
    t = tcls.build_cls_index(reps, list(range(n)), dtype=dtype)
    q = rng.normal(size=(bsz, d)).astype(np.float32)
    cand_ids = rng.integers(0, n, (bsz, pool)).astype(np.int32)
    cand_ids[0, 5:] = -1
    cand_ids[2, 0] = -1
    want = np.asarray(jserve.make_cls_pool_rank_batched()(
        jnp.asarray(q), jnp.asarray(cand_ids), *j.device_arrays()))
    got = tserve.make_cls_pool_rank_batched()(
        torch.from_numpy(q), torch.from_numpy(cand_ids),
        *t.device_arrays("cpu")).numpy()
    pad = cand_ids < 0
    assert (got[pad] == np.float32(-1e30)).all() and (want[pad] < -1e29).all()
    np.testing.assert_allclose(got[~pad], want[~pad], rtol=1e-5, atol=1e-5)
    if dtype == "float32":      # bf16 storage rounds the query in the product
        brute = -np.linalg.norm(q[:, None, :] - reps[np.maximum(cand_ids, 0)],
                                axis=2)
        np.testing.assert_allclose(got[~pad], brute[~pad], rtol=1e-4, atol=1e-4)
