"""Sharded index serving: the port's four gloo ranks against the JAX
package's four-shard mesh on the virtual CPU devices, and against the port's
own one-process search, on the same numpy indexes (built with n_shards=4 in
both packages) and queries.

The ranks are spawned once for the whole file (`served`): each builds the
serving mesh, puts its slices of every index on the CPU and runs every
sharded entry point; the results come back as numpy arrays.  Tolerances are
the JAX package's own sharded-against-single tests'
(tests/test_fused_query.py, test_pool_rank.py, test_index.py,
test_cls_index.py): ids equal; first-stage scores 1e-5; OT rtol and atol
2e-5.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh as JMesh

from aspire_tpu.index import build as jbuild
from aspire_tpu.index import cls as jcls
from aspire_tpu.index import dense as jdense
from aspire_tpu.index import serve as jserve
from aspire_tpu_torch.index import build as tbuild
from aspire_tpu_torch.index import cls as tcls
from aspire_tpu_torch.index import dense as tdense
from aspire_tpu_torch.index import serve as tserve
from aspire_tpu_torch.parallel import mesh as pm

N_SHARDS, DIM, MS, N_DOCS = 4, 16, 10, 60
B, QMAX, POOL = 3, 8, 16
K, K_CLS = 7, 9
DTYPES = ("float32", "int8")
OT = dict(rtol=2e-5, atol=2e-5)
FIRST = dict(rtol=1e-5, atol=1e-5)


def _data():
    rng = np.random.default_rng(15)
    reps = [rng.normal(size=(int(rng.integers(1, MS)), DIM)).astype(np.float32)
            for _ in range(N_DOCS)]
    pids = [f"p{i}" for i in range(N_DOCS)]
    q = rng.normal(size=(B, QMAX, DIM)).astype(np.float32)
    q_lens = rng.integers(1, QMAX + 1, B).astype(np.int32)
    for i in range(B):
        q[i, q_lens[i]:] = 0
    cands = np.stack([rng.choice(N_DOCS, POOL, replace=False)
                      for _ in range(B)]).astype(np.int32)
    cands[1, -3:] = -1                                  # a short pool
    cls_reps = rng.normal(size=(N_DOCS, DIM)).astype(np.float32)
    cls_q = rng.normal(size=(B, DIM)).astype(np.float32)
    return dict(reps=reps, pids=pids, q=q, q_lens=q_lens, cands=cands,
                cls_reps=cls_reps, cls_q=cls_q)


def _port_indexes(data):
    dense = {dt: tdense.build_dense_index(data["reps"], data["pids"],
                                          n_shards=N_SHARDS, dtype=dt)
             for dt in DTYPES}
    flat = tbuild.build_index_from_reps(data["reps"], data["pids"],
                                        n_shards=N_SHARDS)
    cls = tcls.build_cls_index(data["cls_reps"], data["pids"], dtype="float32")
    return dense, flat, cls


def _serve(data, dense, flat, cls, mesh=None):
    """Every sharded entry point (mesh given) or its one-process call."""
    dev = torch.device("cpu") if mesh is None else mesh.device
    t = lambda x: torch.from_numpy(np.asarray(x)).to(dev)
    q, q_lens, cands = t(data["q"]), t(data["q_lens"]), t(data["cands"])
    out = {}
    q0, ql0 = q[0, :int(data["q_lens"][0])], int(data["q_lens"][0])
    if mesh is None:
        out["flat"] = tserve.l2max_search(q0, ql0, *flat.device_arrays("cpu"),
                                          flat.n_docs, 5)
    else:
        out["flat"] = tserve.sharded_l2max_search(flat, mesh, q0.numpy(), ql0,
                                                  5)
    for dt, idx in dense.items():
        int8 = dt == "int8"
        arrays = tdense.flatten_device_buckets(idx.device_arrays(dev, mesh))
        pos = idx.device_pos_arrays(dev, mesh)
        nb = len(idx.buckets)
        out[f"search_{dt}"] = tdense.make_dense_search(
            nb, K, int8=int8, mesh=mesh)(q[0], ql0, *arrays)
        out[f"search_batched_{dt}"] = tdense.make_dense_search_batched(
            nb, K, int8=int8, mesh=mesh)(q, q_lens, *arrays)
        kw = dict(k=K, max_sents=MS, int8=int8, temp=5.0, solver="torch",
                  mesh=mesh)
        out[f"fused_{dt}"] = tserve.make_fused_query(nb, **kw)(
            q[0], ql0, *arrays, *pos)
        out[f"fused_batched_{dt}"] = tserve.make_fused_query_batched(
            nb, rerank_chunk=2, **kw)(q, q_lens, *arrays, *pos)
        for agg in ("ot", "l2max"):
            out[f"pool_{agg}_{dt}"] = tserve.make_pool_rank_batched(
                nb, POOL, MS, agg=agg, int8=int8, temp=5.0, solver="torch",
                mesh=mesh)(q, q_lens, cands, *arrays, *pos)
    reps, norms = cls.device_arrays(dev, mesh)
    cq = t(data["cls_q"])
    out["cls"] = tcls.make_cls_search_batched(K_CLS, mesh=mesh)(cq, reps, norms)
    # k above a shard's 128 rows and above the whole corpus
    out["cls_wide"] = tcls.make_cls_search_batched(150, mesh=mesh)(cq, reps,
                                                                   norms)
    out["cls_pool"] = tserve.make_cls_pool_rank_batched(mesh)(
        cq, cands, reps, norms)
    out["cls_single"] = (tcls.cls_search(cq[0], reps, norms, K_CLS)
                         if mesh is None else tcls.make_sharded_cls_search(
                             mesh, K_CLS)(cq[0], reps, norms))
    return {k: tuple(np.asarray(x.cpu()) for x in v) if isinstance(v, tuple)
            else np.asarray(v.cpu()) for k, v in out.items()}


def _rank(data):
    mesh = pm.make_serving_mesh(N_SHARDS)
    return _serve(data, *_port_indexes(data), mesh=mesh)


def _jax(data):
    mesh = JMesh(np.asarray(jax.devices()[:N_SHARDS]), ("shard",))
    q, q_lens = jnp.asarray(data["q"]), jnp.asarray(data["q_lens"])
    cands = jnp.asarray(data["cands"])
    ql0 = int(data["q_lens"][0])
    out = {}
    flat = jbuild.build_index_from_reps(data["reps"], data["pids"],
                                        n_shards=N_SHARDS)
    out["flat"] = jserve.sharded_l2max_search(flat, mesh, data["q"][0, :ql0],
                                              ql0, 5)
    for dt in DTYPES:
        int8 = dt == "int8"
        idx = jdense.build_dense_index(data["reps"], data["pids"],
                                       n_shards=N_SHARDS,
                                       dtype="int8" if int8 else np.float32)
        arrays = jdense.flatten_device_buckets(idx.device_arrays(mesh))
        pos = idx.device_pos_arrays(mesh)
        nb = len(idx.buckets)
        out[f"search_{dt}"] = jdense.make_dense_search(
            nb, K, mesh=mesh, int8=int8)(q[0], ql0, *arrays)
        out[f"search_batched_{dt}"] = jdense.make_dense_search_batched(
            nb, K, int8=int8, mesh=mesh)(q, q_lens, *arrays)
        kw = dict(k=K, max_sents=MS, int8=int8, temp=5.0, solver="xla",
                  mesh=mesh)
        out[f"fused_{dt}"] = jserve.make_fused_query(nb, **kw)(
            q[0], jnp.int32(ql0), *arrays, *pos)
        out[f"fused_batched_{dt}"] = jserve.make_fused_query_batched(
            nb, **kw)(q, q_lens, *arrays, *pos)
        for agg in ("ot", "l2max"):
            out[f"pool_{agg}_{dt}"] = jserve.make_pool_rank_batched(
                nb, POOL, MS, agg=agg, int8=int8, temp=5.0, solver="xla",
                mesh=mesh)(q, q_lens, cands, *arrays, *pos)
    cls = jcls.build_cls_index(data["cls_reps"], data["pids"], dtype=np.float32)
    reps, norms = cls.device_arrays(mesh)
    cq = jnp.asarray(data["cls_q"])
    out["cls"] = jcls.make_cls_search_batched(K_CLS, mesh=mesh)(cq, reps, norms)
    out["cls_wide"] = jcls.make_cls_search_batched(150, mesh=mesh)(cq, reps,
                                                                   norms)
    out["cls_pool"] = jserve.make_cls_pool_rank_batched(mesh)(cq, cands, reps,
                                                              norms)
    out["cls_single"] = jcls.make_sharded_cls_search(mesh, K_CLS)(cq[0], reps,
                                                                 norms)
    return {k: tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
            else np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def served():
    data = _data()
    ranks = pm.run_ranks(_rank, N_SHARDS, data, device="cpu")
    single = _serve(data, *_port_indexes(data))
    return ranks, single, _jax(data)


def _ids_where_apart(got_ids, want_ids, scores, gap=1e-4):
    """Ids equal wherever a score is apart from its neighbours (ties may
    order differently across merges)."""
    got_ids, want_ids = np.atleast_2d(got_ids), np.atleast_2d(want_ids)
    s = np.atleast_2d(scores)
    apart = np.ones_like(s, bool)
    d = np.abs(np.diff(s, axis=-1)) > gap
    apart[:, 1:] &= d
    apart[:, :-1] &= d
    np.testing.assert_array_equal(got_ids[apart], want_ids[apart])


def test_ranks_return_the_same_results(served):
    ranks, _, _ = served
    for r in ranks[1:]:
        assert r.keys() == ranks[0].keys()
        for key in r:
            got, want = r[key], ranks[0][key]
            for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                              for x in (got, want))):
                np.testing.assert_array_equal(g, w, err_msg=key)


def test_flat_sharded_search(served):
    ranks, single, want = served
    v, d = ranks[0]["flat"]
    np.testing.assert_allclose(v, want["flat"][0], **FIRST)
    _ids_where_apart(d, want["flat"][1], v)
    np.testing.assert_allclose(v, single["flat"][0], **FIRST)
    _ids_where_apart(d, single["flat"][1], v)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["search", "search_batched"])
def test_dense_sharded_search(served, kind, dtype):
    ranks, single, want = served
    key = f"{kind}_{dtype}"
    v, d = ranks[0][key]
    for ref in (want[key], single[key]):
        np.testing.assert_allclose(v, ref[0], **FIRST)
        _ids_where_apart(d, ref[1], v)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["fused", "fused_batched"])
def test_fused_sharded_query(served, kind, dtype):
    ranks, single, want = served
    key = f"{kind}_{dtype}"
    v, d, s = ranks[0][key]
    for ref in (want[key], single[key]):
        np.testing.assert_allclose(v, ref[0], **FIRST)
        _ids_where_apart(d, ref[1], v)
        np.testing.assert_allclose(s, ref[2], **OT)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("agg", ["ot", "l2max"])
def test_pool_rank_sharded(served, agg, dtype):
    ranks, single, want = served
    key = f"pool_{agg}_{dtype}"
    got = ranks[0][key]
    np.testing.assert_allclose(got, want[key], **OT)
    np.testing.assert_allclose(got, single[key], **OT)
    assert (got[1, -3:] == tserve.NEG).all()


@pytest.mark.parametrize("key", ["cls", "cls_wide"])
def test_cls_sharded_search(served, key):
    ranks, single, want = served
    v, i = ranks[0][key]
    for ref in (want[key], single[key]):
        real = ref[1] >= 0
        np.testing.assert_array_equal(i >= 0, real)
        np.testing.assert_allclose(v[real], ref[0][real], **FIRST)
        _ids_where_apart(np.where(real, i, -1), ref[1], np.where(real, v, 0))
    if key == "cls_wide":
        # more than a shard's 128 rows asked for: every document once, then
        # -1 fillers
        assert sorted(i[0][i[0] >= 0]) == list(range(N_DOCS))


def test_cls_sharded_pool_rank(served):
    ranks, single, want = served
    got = ranks[0]["cls_pool"]
    np.testing.assert_allclose(got, want["cls_pool"], **FIRST)
    np.testing.assert_allclose(got, single["cls_pool"], **FIRST)


def test_single_query_sharded_cls_search(served):
    """make_sharded_cls_search is B = 1 of the batched search."""
    ranks, single, want = served
    v, i = ranks[0]["cls_single"]
    for ref in (want["cls_single"], single["cls_single"],
                tuple(x[0] for x in ranks[0]["cls"])):
        np.testing.assert_allclose(v, ref[0], **FIRST)
        _ids_where_apart(i, ref[1], v)
