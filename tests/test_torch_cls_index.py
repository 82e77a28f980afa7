"""CLS index (index/cls.py): pack, files and search of the port against the
JAX package on the same numpy reps."""
import ml_dtypes
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.index import cls as jcls
from aspire_tpu_torch.index import cls as tcls

JDT = {"bfloat16": ml_dtypes.bfloat16, "float32": np.float32}


def _bits(arr):
    arr = np.asarray(arr)
    return arr.view(np.uint16) if arr.dtype == ml_dtypes.bfloat16 else arr


@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("dtype", [None, "bfloat16", "float32"])
def test_pack_cls_index_equal_arrays(rng, dtype, n_shards):
    reps = rng.normal(size=(37, 16)).astype(np.float32)
    want_r, want_n = jcls.pack_cls_index(reps, n_shards, JDT.get(dtype))
    got_r, got_n = tcls.pack_cls_index(reps, n_shards, dtype)
    assert got_r.shape == (128 * n_shards, 16)
    np.testing.assert_array_equal(got_r, _bits(want_r))
    np.testing.assert_array_equal(got_n, want_n)
    assert np.isinf(got_n[37:]).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cls_index_files_cross_both_ways(rng, tmp_path, dtype):
    reps = rng.normal(size=(21, 16)).astype(np.float32)
    pids = list(range(500, 521))
    j = jcls.build_cls_index(reps, pids, dtype=JDT[dtype])
    t = tcls.build_cls_index(reps, pids, dtype=dtype)
    j.save(tmp_path / "from_jax")
    t.save(tmp_path / "from_port")
    t2 = tcls.ClsIndex.load(tmp_path / "from_jax")
    j2 = jcls.ClsIndex.load(tmp_path / "from_port")
    assert t2.rep_dtype == dtype and t2.pids == pids == j2.pids
    assert t2.n_docs == 21 and t2.dim == 16
    np.testing.assert_array_equal(t2.reps, t.reps)
    np.testing.assert_array_equal(_bits(j2.reps), _bits(j.reps))
    assert np.asarray(j2.reps).dtype == np.asarray(j.reps).dtype
    np.testing.assert_array_equal(t2.norms, j2.norms)
    r, n = t2.device_arrays("cpu")
    assert r.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    np.testing.assert_array_equal(r.float().numpy(),
                                  np.asarray(j.reps).astype(np.float32))


@pytest.mark.parametrize("q_chunk", [None, 2])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cls_search_batched_matches_jax(rng, dtype, q_chunk):
    reps = rng.normal(size=(50, 16)).astype(np.float32)
    j = jcls.build_cls_index(reps, list(range(50)), dtype=JDT[dtype])
    t = tcls.build_cls_index(reps, list(range(50)), dtype=dtype)
    q = rng.normal(size=(4, 16)).astype(np.float32)
    v_want, i_want = jcls.make_cls_search_batched(k=7, q_chunk=q_chunk)(
        jnp.asarray(q), *j.device_arrays())
    v, i = tcls.make_cls_search_batched(k=7, q_chunk=q_chunk)(
        torch.from_numpy(q), *t.device_arrays("cpu"))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_want))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_want), rtol=1e-5, atol=1e-5)
    v1, i1 = tcls.cls_search(torch.from_numpy(q[2]), *t.device_arrays("cpu"), k=7)
    np.testing.assert_array_equal(i1.numpy(), i[2].numpy())
    np.testing.assert_allclose(v1.numpy(), v[2].numpy(), rtol=1e-6, atol=1e-6)
    stored = t.device_arrays("cpu")[0].float().numpy()[:50]
    brute = -np.linalg.norm(q[:, None, :] - stored[None], axis=2)
    np.testing.assert_array_equal(i.numpy(), np.argsort(-brute, axis=1)[:, :7])


def test_cls_search_short_pool_gives_minus_one(rng):
    """k past the corpus and past the padded rows: -1 fillers in both."""
    reps = rng.normal(size=(5, 16)).astype(np.float32)
    jr, jn = jcls.pack_cls_index(reps)
    tr, tn = tcls.pack_cls_index(reps)
    q = rng.normal(size=(16,)).astype(np.float32)
    for k in (12, 200):
        _, i_want = jcls.cls_search(jnp.asarray(q), jnp.asarray(jr),
                                    jnp.asarray(jn), k=k)
        t = tcls.ClsIndex(tr, tn, list(range(5)))
        v, i = tcls.cls_search(torch.from_numpy(q), *t.device_arrays("cpu"), k=k)
        assert i.shape == (k,)
        np.testing.assert_array_equal(i.numpy()[:5], np.asarray(i_want)[:5])
        assert (i.numpy()[5:] == -1).all() and (np.asarray(i_want)[5:] == -1).all()
        assert np.isfinite(v.numpy()[:5]).all()


def test_cls_q_chunk_must_divide_the_batch(rng):
    t = tcls.build_cls_index(rng.normal(size=(5, 8)).astype(np.float32), list("abcde"))
    with pytest.raises(AssertionError, match="must divide"):
        tcls.make_cls_search_batched(k=2, q_chunk=2)(
            torch.zeros((3, 8)), *t.device_arrays("cpu"))
