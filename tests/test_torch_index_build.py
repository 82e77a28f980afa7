"""Flat index (index/build.py, l2max_search, gather_doc_reps): the port
against the JAX package on the same numpy corpus, and each package loading
what the other saved."""
import ml_dtypes
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.index import build as jbuild
from aspire_tpu.index import serve as jserve
from aspire_tpu_torch.index import build as tbuild
from aspire_tpu_torch.index import serve as tserve


def make_corpus(rng, n_docs=40, d=16):
    reps = [rng.normal(size=(int(rng.integers(1, 8)), d)).astype(np.float32)
            for _ in range(n_docs)]
    return reps, [f"p{i}" for i in range(n_docs)]


def _bits(arr):
    """A JAX-side host array as the port keeps it: bf16 as uint16 bits."""
    arr = np.asarray(arr)
    return arr.view(np.uint16) if arr.dtype == ml_dtypes.bfloat16 else arr


def test_bf16_rounding_matches_ml_dtypes(rng):
    x = np.concatenate([
        rng.normal(size=4096).astype(np.float32) * 10.0 ** rng.integers(-20, 20, 4096),
        np.array([0.0, -0.0, np.inf, -np.inf, 1.0, 1.00390625, 1.01171875,
                  3.3895314e38, -3.3895314e38, 1e-40], np.float32)])
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(tbuild.f32_to_bf16_bits(x), want)
    np.testing.assert_array_equal(tbuild.bf16_bits_to_f32(want),
                                  want.view(ml_dtypes.bfloat16).astype(np.float32))
    nan = tbuild.bf16_bits_to_f32(tbuild.f32_to_bf16_bits(
        np.array([np.nan], np.float32)))
    assert np.isnan(nan).all()


@pytest.mark.parametrize("n_shards", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_index_from_reps_equal_arrays(rng, n_shards, dtype):
    reps, pids = make_corpus(rng)
    jdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    want = jbuild.build_index_from_reps(reps, pids, n_shards=n_shards, dtype=jdt)
    got = tbuild.build_index_from_reps(reps, pids, n_shards=n_shards, dtype=dtype)
    assert got.n_shards == n_shards and got.n_docs == 40 and got.dim == 16
    np.testing.assert_array_equal(got.sents, _bits(want.sents))
    np.testing.assert_array_equal(got.doc_ids, want.doc_ids)
    np.testing.assert_array_equal(got.doc_lens, want.doc_lens)
    assert got.pids == want.pids and got.dtype == dtype
    if dtype == "bfloat16":
        also = tbuild.build_index_from_reps(reps, pids, n_shards=n_shards,
                                            dtype=torch.bfloat16)
        np.testing.assert_array_equal(also.sents, got.sents)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_index_files_cross_both_ways(rng, tmp_path, dtype):
    reps, _ = make_corpus(rng, n_docs=12)
    pids = [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18]
    jdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    j = jbuild.build_index_from_reps(reps, pids, n_shards=2, dtype=jdt)
    t = tbuild.build_index_from_reps(reps, pids, n_shards=2, dtype=dtype)
    j.save(tmp_path / "from_jax")
    t.save(tmp_path / "from_port")
    t2 = tbuild.MultiVecIndex.load(tmp_path / "from_jax")
    j2 = jbuild.MultiVecIndex.load(tmp_path / "from_port")
    assert t2.dtype == dtype and t2.pids == pids == j2.pids
    assert all(isinstance(p, int) for p in t2.pids)
    np.testing.assert_array_equal(t2.sents, t.sents)
    np.testing.assert_array_equal(_bits(j2.sents), _bits(j.sents))
    assert np.asarray(j2.sents).dtype == np.asarray(j.sents).dtype
    for a, b in ((t2.doc_ids, t.doc_ids), (j2.doc_ids, j.doc_ids),
                 (t2.doc_lens, j2.doc_lens)):
        np.testing.assert_array_equal(a, b)
    sents, doc_ids = t2.device_arrays("cpu")
    assert sents.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    np.testing.assert_array_equal(sents.float().numpy(),
                                  np.asarray(j.sents).astype(np.float32))
    assert doc_ids.dtype == torch.int32


def test_pids_fall_back_to_pid2idx(tmp_path):
    tbuild.save_pids(tmp_path, ["a", "b", "c"])
    assert tbuild.load_pids(tmp_path) == ["a", "b", "c"] == jbuild.load_pids(tmp_path)
    (tmp_path / "pids.json").unlink()
    assert tbuild.load_pids(tmp_path) == ["a", "b", "c"]


@pytest.mark.parametrize("dtype,n_shards,q_len", [("float32", 1, 5),
                                                  ("float32", 4, 2),
                                                  ("bfloat16", 2, 6)])
def test_l2max_search_matches_jax(rng, dtype, n_shards, q_len):
    reps, pids = make_corpus(rng)
    jdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    j = jbuild.build_index_from_reps(reps, pids, n_shards=n_shards, dtype=jdt)
    t = tbuild.build_index_from_reps(reps, pids, n_shards=n_shards, dtype=dtype)
    q = rng.normal(size=(6, 16)).astype(np.float32)
    v_want, d_want = jserve.l2max_search(
        jnp.asarray(q), jnp.int32(q_len), jnp.asarray(np.asarray(j.sents)),
        jnp.asarray(j.doc_ids), j.n_docs, 10)
    sents, doc_ids = t.device_arrays("cpu")
    v, d = tserve.l2max_search(torch.from_numpy(q), q_len, sents, doc_ids,
                               t.n_docs, 10)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_want))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_want), rtol=1e-4, atol=1e-4)
    # the shard axis may also be flattened by the caller
    v2, d2 = tserve.l2max_search(torch.from_numpy(q), q_len,
                                 sents.reshape(-1, 16), doc_ids.reshape(-1),
                                 t.n_docs, 10)
    assert torch.equal(d2, d) and torch.equal(v2, v)


def test_per_doc_scores_of_a_partial_shard(rng):
    """A doc with no sentence in the shard scores -inf, as segment_max gives."""
    reps, pids = make_corpus(rng, n_docs=9)
    t = tbuild.build_index_from_reps(reps, pids, n_shards=3)
    q = rng.normal(size=(4, 16)).astype(np.float32)
    want = np.asarray(jserve._per_doc_scores(
        jnp.asarray(q), jnp.int32(4), jnp.asarray(t.sents[1]),
        jnp.asarray(t.doc_ids[1]), 9))
    got = tserve._per_doc_scores(torch.from_numpy(q), 4,
                                 torch.from_numpy(t.sents[1]),
                                 torch.from_numpy(t.doc_ids[1]), 9).numpy()
    assert np.isneginf(got).any()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    live = ~np.isneginf(got)
    np.testing.assert_allclose(got[live], want[live], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_doc_reps_matches_jax_with_pad_ids(rng, dtype):
    reps, pids = make_corpus(rng, n_docs=20)
    jdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    j = jbuild.build_index_from_reps(reps, pids, n_shards=2, dtype=jdt)
    t = tbuild.build_index_from_reps(reps, pids, n_shards=2, dtype=dtype)
    doc_idx = np.array([3, -1, 11, 19, -1, 0])
    if dtype == "bfloat16":          # the JAX gather writes bf16 rows into f32
        j = jbuild.MultiVecIndex(np.asarray(j.sents).astype(np.float32),
                                 j.doc_ids, j.doc_lens, j.pids)
    want = jserve.gather_doc_reps(j, doc_idx, max_sents=5)
    got = tserve.gather_doc_reps(t, doc_idx, max_sents=5, device="cpu")
    np.testing.assert_array_equal(got.embed.numpy(), np.asarray(want.embed))
    np.testing.assert_array_equal(got.lens.numpy(), np.asarray(want.lens))
    assert (got.embed[1] == 0).all() and int(got.lens[4]) == 0


def test_device_arrays_default_to_cuda_and_raise_without():
    idx = tbuild.build_index_from_reps([np.ones((2, 4), np.float32)], ["a"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            idx.device_arrays()
        with pytest.raises(RuntimeError, match="cuda"):
            tserve.gather_doc_reps(idx, [0], 4)
