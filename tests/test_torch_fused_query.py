"""Fused query path (search + device gather + OT rerank) and the on-device
candidate gather: the port against the JAX package on the same numpy index
and queries."""
import ml_dtypes
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.index import dense as jdense
from aspire_tpu.index import serve as jserve
from aspire_tpu_torch.core.types import MultiVec as TMV
from aspire_tpu_torch.index import dense as tdense
from aspire_tpu_torch.index import serve as tserve

DIM, MS = 16, 10
JDT = {"bfloat16": ml_dtypes.bfloat16, "float32": np.float32, "int8": "int8"}
SOLVERS = [("xla", "torch"), ("pallas", "kernel")]


def _indexes(rng, n_docs, dtype, buckets=jdense.DEFAULT_BUCKETS):
    reps = [rng.normal(size=(int(rng.integers(1, 10)), DIM)).astype(np.float32)
            for _ in range(n_docs)]
    pids = [f"p{i}" for i in range(n_docs)]
    j = jdense.build_dense_index(reps, pids, dtype=JDT[dtype], buckets=buckets)
    t = tdense.build_dense_index(reps, pids, dtype=dtype, buckets=buckets)
    return j, t


def _args(j, t):
    return ((*jdense.flatten_device_buckets(j.device_arrays()),
             *j.device_pos_arrays()),
            (*tdense.flatten_device_buckets(t.device_arrays("cpu")),
             *t.device_pos_arrays("cpu")))


def _queries(rng, bsz, qmax=8):
    q = rng.normal(size=(bsz, qmax, DIM)).astype(np.float32)
    q_lens = rng.integers(1, qmax + 1, bsz).astype(np.int32)
    for i in range(bsz):
        q[i, q_lens[i]:] = 0
    return q, q_lens


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_gather_candidates_matches_jax_with_pad_ids(rng, dtype):
    j, t = _indexes(rng, 30, dtype)
    ids = np.array([4, -1, 29, 0, -1, 17, 4], np.int32)
    for max_sents in (MS, 3):
        emb_w, cl_w, owned_w, valid_w = jserve._gather_candidates(
            j.device_arrays(), *j.device_pos_arrays(), jnp.asarray(ids), max_sents)
        emb, cl, owned, valid = tserve._gather_candidates(
            t.device_arrays("cpu"), *t.device_pos_arrays("cpu"),
            torch.from_numpy(ids), max_sents)
        np.testing.assert_array_equal(emb.numpy(), np.asarray(emb_w))
        np.testing.assert_array_equal(cl.numpy(), np.asarray(cl_w))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_w))
        np.testing.assert_array_equal(owned.numpy(), np.asarray(owned_w))
        assert (emb[1] == 0).all() and (emb[4] == 0).all()   # not the last doc
        host = t.gather_doc_reps(ids, max_sents, device="cpu")
        np.testing.assert_array_equal(emb.numpy(), host.embed.numpy())


@pytest.mark.parametrize("j_solver,t_solver", SOLVERS)
@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_fused_query_matches_jax(rng, dtype, j_solver, t_solver):
    j, t = _indexes(rng, 40, dtype)
    jargs, targs = _args(j, t)
    q, q_lens = _queries(rng, 1)
    q, q_len = q[0], int(q_lens[0])
    int8 = dtype == "int8"
    want = jserve.make_fused_query(len(j.buckets), k=7, max_sents=MS, int8=int8,
                                   temp=5.0, solver=j_solver)(
        jnp.asarray(q), jnp.int32(q_len), *jargs)
    for scan in ("kernel", "torch"):
        v, d, s = tserve.make_fused_query(
            len(t.buckets), k=7, max_sents=MS, int8=int8, temp=5.0,
            solver=t_solver, scan=scan)(torch.from_numpy(q), q_len, *targs)
        np.testing.assert_array_equal(d.numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(v.numpy(), np.asarray(want[0]),
                                   rtol=2e-4, atol=2e-4)
        # ~70 annealing rounds, then exp(. / blur) with blur 0.05
        np.testing.assert_allclose(s.numpy(), np.asarray(want[2]),
                                   rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_fused_query_matches_staged_path(rng, dtype):
    """search -> host gather -> ot_rerank gives what the fused query gives."""
    _, t = _indexes(rng, 40, dtype)
    flat = tdense.flatten_device_buckets(t.device_arrays("cpu"))
    pos = t.device_pos_arrays("cpu")
    q, q_lens = _queries(rng, 1)
    q, q_len = torch.from_numpy(q[0]), int(q_lens[0])
    int8 = dtype == "int8"
    v, d, s = tserve.make_fused_query(len(t.buckets), k=7, max_sents=MS,
                                      int8=int8, temp=5.0, solver="torch")(
        q, q_len, *flat, *pos)
    v_s, d_s = tdense.make_dense_search(len(t.buckets), k=7, int8=int8)(
        q, q_len, *flat)
    cands = t.gather_doc_reps(d_s.numpy(), MS, device="cpu")
    s_s = tserve.ot_rerank(TMV(q[None], torch.tensor([q_len])), cands,
                           temp=5.0, solver="torch")
    assert torch.equal(d, d_s) and torch.equal(v, v_s)
    np.testing.assert_allclose(s.numpy(), s_s.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("j_solver,t_solver", SOLVERS)
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_fused_batched_matches_jax_and_single(rng, dtype, j_solver, t_solver):
    """One solve for all B * k pairs, each annealed from its own query's pool
    diameter, against the JAX package's per-query map; and B=1 == single."""
    j, t = _indexes(rng, 40, dtype)
    jargs, targs = _args(j, t)
    q, q_lens = _queries(rng, 3)
    int8 = dtype == "int8"
    want = jserve.make_fused_query_batched(
        len(j.buckets), k=6, max_sents=MS, int8=int8, temp=5.0,
        solver=j_solver)(jnp.asarray(q), jnp.asarray(q_lens), *jargs)
    kw = dict(k=6, max_sents=MS, int8=int8, temp=5.0, solver=t_solver)
    got = tserve.make_fused_query_batched(len(t.buckets), **kw)(
        torch.from_numpy(q), torch.from_numpy(q_lens), *targs)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=2e-3, atol=2e-3)
    single = tserve.make_fused_query(len(t.buckets), **kw)
    chunked = tserve.make_fused_query_batched(
        len(t.buckets), rerank_chunk=2, q_chunk=1, **kw)(
        torch.from_numpy(q), torch.from_numpy(q_lens), *targs)
    for i in range(3):
        v1, d1, s1 = single(torch.from_numpy(q[i]), int(q_lens[i]), *targs)
        np.testing.assert_array_equal(d1.numpy(), got[1][i].numpy())
        np.testing.assert_allclose(v1.numpy(), got[0][i].numpy(), atol=1e-5)
        np.testing.assert_allclose(s1.numpy(), got[2][i].numpy(),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(chunked[2][i].numpy(), got[2][i].numpy(),
                                   rtol=2e-5, atol=2e-5)
    assert torch.equal(chunked[1], got[1])


def test_queries_do_not_couple_through_the_diameter(rng):
    """A far-away second query must not move the first one's OT scores."""
    _, t = _indexes(rng, 40, "float32")
    flat = tdense.flatten_device_buckets(t.device_arrays("cpu"))
    pos = t.device_pos_arrays("cpu")
    q, q_lens = _queries(rng, 2)
    fn = tserve.make_fused_query_batched(len(t.buckets), k=6, max_sents=MS,
                                         temp=5.0, solver="torch")
    base = fn(torch.from_numpy(q), torch.from_numpy(q_lens), *flat, *pos)
    q[1] *= 50.0
    moved = fn(torch.from_numpy(q), torch.from_numpy(q_lens), *flat, *pos)
    assert torch.equal(base[1][0], moved[1][0])
    np.testing.assert_allclose(moved[2][0].numpy(), base[2][0].numpy(),
                               rtol=1e-6, atol=1e-6)
    assert not torch.allclose(moved[2][1], base[2][1])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_fused_pads_when_pool_smaller_than_k(rng, dtype):
    j, t = _indexes(rng, 5, dtype)
    jargs, targs = _args(j, t)
    q, _ = _queries(rng, 1)
    int8 = dtype == "int8"
    want = jserve.make_fused_query(len(j.buckets), k=9, max_sents=MS, int8=int8,
                                   temp=5.0)(jnp.asarray(q[0]), jnp.int32(8), *jargs)
    v, d, s = tserve.make_fused_query(len(t.buckets), k=9, max_sents=MS,
                                      int8=int8, temp=5.0, solver="torch")(
        torch.from_numpy(q[0]), 8, *targs)
    d, d_want = d.numpy(), np.asarray(want[1])
    real = d >= 0
    assert real.sum() == 5 and (d_want >= 0).sum() == 5
    np.testing.assert_array_equal(d[real], d_want[real])
    assert (s.numpy()[~real] < -1e29).all()
    np.testing.assert_allclose(s.numpy()[real], np.asarray(want[2])[real],
                               rtol=2e-3, atol=2e-3)


def test_fused_query_defaults_to_the_kernels():
    import inspect
    for fn in (tserve.make_fused_query, tserve.make_fused_query_batched):
        params = inspect.signature(fn).parameters
        assert params["solver"].default == "kernel"
        assert params["scan"].default == "kernel"
    assert inspect.signature(tserve.make_pool_rank_batched).parameters[
        "solver"].default == "kernel"
