"""Dense-bucket index (index/dense.py): build, files, gather and search of the
port against the JAX package on the same numpy corpus."""
import ml_dtypes
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.index import dense as jdense
from aspire_tpu_torch.index import dense as tdense

JDT = {"bfloat16": ml_dtypes.bfloat16, "float32": np.float32, "int8": "int8"}


def make_corpus(rng, n_docs=60, d=16, max_s=10):
    reps = [rng.normal(size=(int(rng.integers(1, max_s)), d)).astype(np.float32)
            for _ in range(n_docs)]
    return reps, [f"p{i}" for i in range(n_docs)]


def _bits(arr):
    arr = np.asarray(arr)
    return arr.view(np.uint16) if arr.dtype == ml_dtypes.bfloat16 else arr


def assert_same_index(t, j):
    assert len(t.buckets) == len(j.buckets)
    for tb, jb in zip(t.buckets, j.buckets):
        assert set(tb) == set(jb)
        for key in tb:
            got, want = tb[key], _bits(jb[key])
            assert got.dtype == want.dtype and got.shape == want.shape, key
            np.testing.assert_array_equal(got, want, err_msg=key)
    np.testing.assert_array_equal(t.doc_lens, j.doc_lens)
    assert t.pids == j.pids and t.score_type == j.score_type
    assert t.is_int8 == j.is_int8 and t.n_docs == j.n_docs and t.dim == j.dim


@pytest.mark.parametrize("n_shards", [1, 3])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_build_dense_index_equal_arrays(rng, dtype, n_shards):
    reps, pids = make_corpus(rng)
    reps.append(rng.normal(size=(40, 16)).astype(np.float32))   # truncated to 24
    reps.append(np.zeros((2, 16), np.float32))                  # zero rows: scale 1
    pids += ["long", "zero"]
    j = jdense.build_dense_index(reps, pids, n_shards=n_shards, dtype=JDT[dtype])
    t = tdense.build_dense_index(reps, pids, n_shards=n_shards, dtype=dtype)
    assert_same_index(t, j)
    assert t.sent_dtype == dtype and t.doc_lens[-2] == 24
    t._ensure_doc_pos(), j._ensure_doc_pos()
    np.testing.assert_array_equal(t._doc_bucket, j._doc_bucket)
    np.testing.assert_array_equal(t._doc_row, j._doc_row)


def test_build_dense_index_dtype_spellings(rng):
    reps, pids = make_corpus(rng, n_docs=9)
    base = tdense.build_dense_index(reps, pids)
    assert base.sent_dtype == "bfloat16"
    for spelling in (torch.bfloat16, "bfloat16"):
        assert_same = tdense.build_dense_index(reps, pids, dtype=spelling)
        np.testing.assert_array_equal(assert_same.buckets[0]["sents"],
                                      base.buckets[0]["sents"])
    for spelling in (np.float32, torch.float32, "float32"):
        assert tdense.build_dense_index(reps, pids, dtype=spelling).sent_dtype == "float32"
    for spelling in (np.int8, torch.int8, "int8"):
        assert tdense.build_dense_index(reps, pids, dtype=spelling).is_int8
    with pytest.raises(ValueError, match="storage"):
        tdense.build_dense_index(reps, pids, dtype="float16")


def test_quantize_sentences_and_prequantized_build_bit_for_bit(rng):
    """quantize_sentences + build_dense_index_prequantized ==
    build_dense_index(dtype='int8') of either package, every array equal."""
    reps, pids = make_corpus(rng, n_docs=40)
    reps[5][1] = 0.0                                  # an all-zero sentence
    host_j = jdense.build_dense_index(reps, pids, dtype="int8")
    host_t = tdense.build_dense_index(reps, pids, dtype="int8")
    quant = []
    for r in reps:
        xi, sc = tdense.quantize_sentences(torch.from_numpy(r))
        assert xi.dtype == torch.int8 and sc.dtype == torch.float32
        quant.append((xi.numpy(), sc.numpy()))
    assert quant[5][1][1] == 1.0 and (quant[5][0][1] == 0).all()
    pre_t = tdense.build_dense_index_prequantized(quant, pids)
    pre_j = jdense.build_dense_index_prequantized(quant, pids)
    assert_same_index(pre_t, pre_j)
    for bh, bj, bp in zip(host_t.buckets, host_j.buckets, pre_t.buckets):
        for key in ("sents", "scales", "doc_idx"):
            np.testing.assert_array_equal(bp[key], bh[key], err_msg=key)
            np.testing.assert_array_equal(bp[key], bj[key], err_msg=key)
        # norms: an int32 sum against a float32 one of the same integers
        np.testing.assert_allclose(bp["norms"], bh["norms"], rtol=1e-6)
    # a padded batch quantises as its rows do
    batch = np.zeros((3, 9, 16), np.float32)
    for i in range(3):
        batch[i, :len(reps[i])] = reps[i]
    xi, sc = tdense.quantize_sentences(torch.from_numpy(batch))
    for i in range(3):
        np.testing.assert_array_equal(xi[i, :len(reps[i])].numpy(), quant[i][0])
        np.testing.assert_array_equal(sc[i, :len(reps[i])].numpy(), quant[i][1])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_dense_index_files_cross_both_ways(rng, tmp_path, dtype):
    reps, _ = make_corpus(rng, n_docs=20)
    pids = list(range(100, 120))
    score_type = "cosine" if dtype == "float32" else "l2"
    j = jdense.build_dense_index(reps, pids, dtype=JDT[dtype], score_type=score_type)
    t = tdense.build_dense_index(reps, pids, dtype=dtype, score_type=score_type)
    j.save(tmp_path / "from_jax")
    t.save(tmp_path / "from_port")
    t2 = tdense.DenseBucketIndex.load(tmp_path / "from_jax")
    j2 = jdense.DenseBucketIndex.load(tmp_path / "from_port")
    assert_same_index(t2, j)
    assert_same_index(t, j2)
    assert t2.sent_dtype == dtype and all(isinstance(p, int) for p in t2.pids)
    assert np.asarray(j2.buckets[0]["sents"]).dtype == np.asarray(
        j.buckets[0]["sents"]).dtype
    # and what the port loads goes to the device as the JAX arrays do
    for tb, jb in zip(t2.device_arrays("cpu"), j.device_arrays()):
        assert tb["sents"].dtype == {"bfloat16": torch.bfloat16,
                                     "float32": torch.float32,
                                     "int8": torch.int8}[dtype]
        np.testing.assert_array_equal(
            tb["sents"].float().numpy(),
            np.asarray(jb["sents"]).astype(np.float32))
        np.testing.assert_array_equal(tb["norms"].numpy(), np.asarray(jb["norms"]))
    for a, b in zip(t2.device_pos_arrays("cpu"), j.device_pos_arrays()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_gather_doc_reps_matches_jax_with_pad_ids(rng, dtype):
    reps, pids = make_corpus(rng, n_docs=30)
    j = jdense.build_dense_index(reps, pids, dtype=JDT[dtype])
    t = tdense.build_dense_index(reps, pids, dtype=dtype)
    ids = [2, -1, 5, 29, -1, 17, 2]
    for max_sents in (12, 3):
        want = j.gather_doc_reps(ids, max_sents=max_sents)
        got = t.gather_doc_reps(ids, max_sents=max_sents, device="cpu")
        np.testing.assert_array_equal(got.lens.numpy(), np.asarray(want.lens))
        np.testing.assert_array_equal(got.embed.numpy(), np.asarray(want.embed))
        assert (got.embed[1] == 0).all() and int(got.lens[1]) == 0


def _query(rng, d, qmax, q_len):
    q = np.zeros((qmax, d), np.float32)
    q[:q_len] = rng.normal(size=(q_len, d)).astype(np.float32)
    return q


@pytest.mark.parametrize("scan", ["kernel", "torch"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_dense_search_matches_jax(rng, dtype, scan):
    reps, pids = make_corpus(rng)
    j = jdense.build_dense_index(reps, pids, dtype=JDT[dtype])
    t = tdense.build_dense_index(reps, pids, dtype=dtype)
    int8 = dtype == "int8"
    q = _query(rng, 16, 8, 5)
    j_search = jdense.make_dense_search(len(j.buckets), k=10, int8=int8,
                                        exact=dtype == "float32")
    v_want, d_want = j_search(jnp.asarray(q), jnp.int32(5),
                              *jdense.flatten_device_buckets(j.device_arrays()))
    flat = tdense.flatten_device_buckets(t.device_arrays("cpu"))
    search = tdense.make_dense_search(len(t.buckets), k=10, int8=int8,
                                      exact=dtype == "float32", scan=scan)
    v, d = search(torch.from_numpy(q), 5, *flat)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_want))
    # -sqrt of sums of 16 products in another order
    np.testing.assert_allclose(v.numpy(), np.asarray(v_want), rtol=2e-4, atol=2e-4)
    # q_len may be a tensor as well
    v2, d2 = search(torch.from_numpy(q), torch.tensor(5), *flat)
    assert torch.equal(d2, d) and torch.equal(v2, v)


@pytest.mark.parametrize("q_chunk", [None, 2])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_dense_search_batched_matches_jax_and_single(rng, dtype, q_chunk):
    reps, pids = make_corpus(rng)
    j = jdense.build_dense_index(reps, pids, dtype=JDT[dtype])
    t = tdense.build_dense_index(reps, pids, dtype=dtype)
    int8 = dtype == "int8"
    q_lens = np.array([8, 3, 1, 5], np.int32)
    q = np.stack([_query(rng, 16, 8, int(n)) for n in q_lens])
    v_want, d_want = jdense.make_dense_search_batched(
        len(j.buckets), k=10, int8=int8, q_chunk=q_chunk,
        exact=dtype == "float32")(
        jnp.asarray(q), jnp.asarray(q_lens),
        *jdense.flatten_device_buckets(j.device_arrays()))
    flat = tdense.flatten_device_buckets(t.device_arrays("cpu"))
    v, d = tdense.make_dense_search_batched(
        len(t.buckets), k=10, int8=int8, q_chunk=q_chunk)(
        torch.from_numpy(q), torch.from_numpy(q_lens), *flat)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_want))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_want), rtol=2e-4, atol=2e-4)
    single = tdense.make_dense_search(len(t.buckets), k=10, int8=int8)
    for i in range(4):
        v1, d1 = single(torch.from_numpy(q[i]), int(q_lens[i]), *flat)
        np.testing.assert_array_equal(d1.numpy(), d[i].numpy())
        np.testing.assert_allclose(v1.numpy(), v[i].numpy(), rtol=1e-5, atol=1e-5)


def test_q_chunk_must_divide_the_batch(rng):
    reps, pids = make_corpus(rng, n_docs=9)
    t = tdense.build_dense_index(reps, pids)
    flat = tdense.flatten_device_buckets(t.device_arrays("cpu"))
    with pytest.raises(AssertionError, match="must divide"):
        tdense.make_dense_search_batched(len(t.buckets), k=3, q_chunk=2)(
            torch.zeros((3, 4, 16)), torch.tensor([1, 1, 1]), *flat)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_short_pool_pads_with_minus_one(rng, dtype):
    """k > n_docs: the tail is -1 ids at NEG, in both packages."""
    reps, pids = make_corpus(rng, n_docs=5)
    j = jdense.build_dense_index(reps, pids, dtype=JDT[dtype], buckets=(12,))
    t = tdense.build_dense_index(reps, pids, dtype=dtype, buckets=(12,))
    int8 = dtype == "int8"
    q = _query(rng, 16, 8, 4)
    v_want, d_want = jdense.make_dense_search(1, k=12, int8=int8)(
        jnp.asarray(q), jnp.int32(4),
        *jdense.flatten_device_buckets(j.device_arrays()))
    v, d = tdense.make_dense_search(1, k=12, int8=int8)(
        torch.from_numpy(q), 4,
        *tdense.flatten_device_buckets(t.device_arrays("cpu")))
    np.testing.assert_array_equal(d.numpy()[:5], np.asarray(d_want)[:5])
    assert (d.numpy()[5:] == -1).all() and (np.asarray(d_want)[5:] == -1).all()
    np.testing.assert_allclose(v.numpy(), np.asarray(v_want), rtol=2e-4)
    vb, db = tdense.make_dense_search_batched(1, k=12, int8=int8)(
        torch.from_numpy(q)[None], torch.tensor([4]),
        *tdense.flatten_device_buckets(t.device_arrays("cpu")))
    np.testing.assert_array_equal(db[0].numpy(), d.numpy())


def test_cosine_index_scores_convert_to_cosine(rng):
    reps, pids = make_corpus(rng, n_docs=40)
    unit = [r / np.linalg.norm(r, axis=1, keepdims=True) for r in reps]
    t = tdense.build_dense_index(unit, pids, dtype="float32", score_type="cosine")
    q = _query(rng, 16, 8, 3)
    q[:3] /= np.linalg.norm(q[:3], axis=1, keepdims=True)
    v, d = tdense.make_dense_search(len(t.buckets), k=10, exact=True)(
        torch.from_numpy(q), 3,
        *tdense.flatten_device_buckets(t.device_arrays("cpu")))
    want = np.array([np.max(q[:3] @ r.T) for r in unit])
    order = np.argsort(-want)
    np.testing.assert_array_equal(d.numpy(), order[:10])
    np.testing.assert_allclose(1.0 - v.numpy() ** 2 / 2.0, want[order[:10]],
                               rtol=1e-5, atol=1e-5)
