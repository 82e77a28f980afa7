"""First-stage scans (K8, K7): the Pallas kernels in interpret mode and the
JAX index scorers against the port's wrappers (plain versions on the CPU)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.index import dense as jdense
from aspire_tpu.ops import pallas_scan as jscan
from aspire_tpu_torch.index import dense as tdense
from aspire_tpu_torch.ops import scan_kernel as sk


def _bucket(rng, n, s, d, pad_share=0.3, all_pad_doc=True):
    sents = rng.normal(size=(n, s, d)).astype(np.float32)
    pad = rng.random((n, s)) < pad_share
    if all_pad_doc:
        pad[n // 2] = True
    sents[pad] = 0.0
    norms = np.einsum("nsd,nsd->ns", sents, sents).astype(np.float32)
    norms[pad] = np.inf
    return sents, norms


@pytest.mark.parametrize("n,s,d,q_n,qpad", [(256, 4, 128, 5, 8),
                                            (128, 12, 128, 16, 16),
                                            (128, 7, 256, 1, 8)])
def test_bf16_scan_matches_pallas_kernel(rng, n, s, d, q_n, qpad):
    """`fused_l2max_scan` without qadd is the TPU kernel: f32 rows here, as
    the JAX package's own test feeds them."""
    sents, norms = _bucket(rng, n, s, d)
    q = np.zeros((qpad, d), np.float32)
    q[:q_n] = rng.normal(size=(q_n, d)).astype(np.float32)
    want = np.asarray(jscan.fused_l2max_scan(
        jnp.asarray(sents), jnp.asarray(q), jnp.asarray(norms), q_n=q_n,
        block_docs=128, interpret=True))
    got = sk.fused_l2max_scan(torch.from_numpy(sents), torch.from_numpy(q),
                              torch.from_numpy(norms), q_n).numpy()
    # a doc of pads only: -inf on one side may be the -1e30 clamp on the other
    np.testing.assert_allclose(np.maximum(got, -1e30), np.maximum(want, -1e30),
                               rtol=1e-4, atol=1e-4)
    brute = (2.0 * np.einsum("nsd,qd->nsq", sents, q[:q_n])
             - norms[:, :, None]).reshape(n, -1).max(axis=1)
    np.testing.assert_allclose(np.maximum(got, -1e30), np.maximum(brute, -1e30),
                               rtol=1e-4, atol=1e-4)


def test_bf16_scan_on_bf16_rows_matches_pallas_kernel(rng):
    import ml_dtypes
    n, s, d, q_n, qpad = 128, 8, 128, 6, 8
    sents, _ = _bucket(rng, n, s, d, all_pad_doc=False)
    stored = sents.astype(ml_dtypes.bfloat16)
    sf = stored.astype(np.float32)
    norms = np.einsum("nsd,nsd->ns", sf, sf).astype(np.float32)
    norms[(sf == 0).all(axis=2)] = np.inf
    q = np.zeros((qpad, d), np.float32)
    q[:q_n] = rng.normal(size=(q_n, d)).astype(np.float32)
    want = np.asarray(jscan.fused_l2max_scan(
        jnp.asarray(stored), jnp.asarray(q), jnp.asarray(norms), q_n=q_n,
        block_docs=128, interpret=True))
    t_sents = torch.from_numpy(sf).to(torch.bfloat16)
    assert torch.equal(t_sents.float(), torch.from_numpy(sf))
    got = sk.fused_l2max_scan(t_sents, torch.from_numpy(q),
                              torch.from_numpy(norms), q_n).numpy()
    np.testing.assert_allclose(np.maximum(got, -1e30), np.maximum(want, -1e30),
                               rtol=1e-4, atol=1e-4)


def test_bf16_scan_with_qadd_is_the_index_scorer(rng):
    """With qadd = -|q_j|^2 inside the max the scan gives `_bucket_topk`'s
    scores; without it and "-|q|^2 outside" it does not, once the query
    sentences differ in norm."""
    n, s, d, q_n, qpad = 64, 6, 32, 5, 8
    sents, norms = _bucket(rng, n, s, d, all_pad_doc=False)
    q = np.zeros((qpad, d), np.float32)
    q[:q_n] = rng.normal(size=(q_n, d)).astype(np.float32) \
        * np.array([0.2, 1.0, 3.0, 0.5, 2.0], np.float32)[:, None]
    q_norms = (q * q).sum(axis=1)
    bucket = {"sents": jnp.asarray(sents), "norms": jnp.asarray(norms),
              "doc_idx": jnp.arange(n, dtype=jnp.int32)}
    v_want, d_want = jdense._bucket_topk(jnp.asarray(q), jnp.asarray(q_norms),
                                         jnp.int32(q_n), bucket, n, exact=True)
    want = np.empty(n, np.float32)
    want[np.asarray(d_want)] = np.asarray(v_want)
    args = (torch.from_numpy(sents), torch.from_numpy(q), torch.from_numpy(norms))
    got = sk.fused_l2max_scan(*args, q_n, qadd=torch.from_numpy(-q_norms)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    bare = sk.fused_l2max_scan(*args, q_n).numpy()
    assert np.abs(bare - q_norms[:q_n].max() - want).max() > 1.0
    assert np.abs(bare - q_norms[:q_n].min() - want).max() > 1.0


@pytest.mark.parametrize("n,s,d,q_n,qpad", [(128, 12, 128, 10, 16),
                                            (128, 5, 64, 3, 8),
                                            (128, 7, 128, 18, 24)])
def test_f32_scan_with_and_without_qadd_matches_pallas_kernel(rng, n, s, d, q_n, qpad):
    """f32 rows, as the CUDA f32 scan takes them (true-f32 product; the last
    case's query spans two of its 16-column chunks).  Without
    qadd: the TPU kernel on the same f32 rows.  With qadd (a term per query
    sentence inside the max): the max over j of the TPU kernel run on query
    sentence j alone plus qadd_j.  f32 sums of up to 128 products in another
    order: rtol/atol 1e-4."""
    sents, norms = _bucket(rng, n, s, d)
    q = np.zeros((qpad, d), np.float32)
    q[:q_n] = rng.normal(size=(q_n, d)).astype(np.float32) \
        * rng.uniform(0.3, 3.0, (q_n, 1)).astype(np.float32)
    qadd = (-(q * q).sum(axis=1) + rng.normal(size=qpad)).astype(np.float32)

    def pallas(qq, q_n_):
        return np.asarray(jscan.fused_l2max_scan(
            jnp.asarray(sents), jnp.asarray(qq), jnp.asarray(norms), q_n=q_n_,
            block_docs=128, interpret=True))

    args = (torch.from_numpy(sents), torch.from_numpy(q), torch.from_numpy(norms))
    got = sk.fused_l2max_scan(*args, q_n).numpy()
    np.testing.assert_allclose(np.maximum(got, -1e30),
                               np.maximum(pallas(q, q_n), -1e30),
                               rtol=1e-4, atol=1e-4)
    got_q = sk.fused_l2max_scan(*args, q_n, qadd=torch.from_numpy(qadd)).numpy()
    one = np.zeros((8, d), np.float32)
    per_col = []
    for j in range(q_n):
        one[0] = q[j]
        per_col.append(pallas(one, 1) + qadd[j])
    want_q = np.max(per_col, axis=0)
    np.testing.assert_allclose(np.maximum(got_q, -1e30),
                               np.maximum(want_q, -1e30), rtol=1e-4, atol=1e-4)
    assert np.isneginf(got_q[n // 2]) or got_q[n // 2] <= -1e30   # a doc of pads


def _int8_bucket(rng, d, n_docs, s):
    reps = [rng.normal(size=(int(rng.integers(1, s + 1)), d)).astype(np.float32)
            for _ in range(n_docs)]
    pids = [f"p{i}" for i in range(n_docs)]
    return (jdense.build_dense_index(reps, pids, buckets=(s,), dtype="int8"),
            tdense.build_dense_index(reps, pids, buckets=(s,), dtype="int8"))


@pytest.mark.parametrize("bsz,qmax,q_lens", [(4, 6, [6, 3, 1, 5]),
                                             (1, 16, [10]),
                                             (5, 20, [20, 1, 7, 13, 2])])
def test_int8_scan_matches_pallas_kernel_and_xla_path(rng, bsz, qmax, q_lens):
    d, n_docs = 128, 57
    jidx, tidx = _int8_bucket(rng, d, n_docs, 8)
    jb, tb = jidx.buckets[0], tidx.buckets[0]
    q = rng.normal(size=(bsz, qmax, d)).astype(np.float32)
    q_lens = np.asarray(q_lens, np.int32)
    want = np.asarray(jscan.fused_l2max_scan_int8_batched(
        jnp.asarray(jb["sents"]), jnp.asarray(jb["scales"]),
        jnp.asarray(jb["norms"]), jnp.asarray(q), jnp.asarray(q_lens),
        qmax=qmax, interpret=True))                        # [N, B]
    got = sk.fused_l2max_scan_int8_batched(
        torch.from_numpy(tb["sents"]), torch.from_numpy(tb["scales"]),
        torch.from_numpy(tb["norms"]), torch.from_numpy(q),
        torch.from_numpy(q_lens), qmax).numpy()
    assert got.shape == (tb["sents"].shape[0], bsz)
    live = tb["doc_idx"] >= 0
    np.testing.assert_allclose(got[live], want[live], rtol=2e-4, atol=2e-4)
    assert (got[~live] <= -0.5e30).all() and (want[~live] <= -0.5e30).all()
    # against the JAX batched scorer: scores and top-k ids
    v_want, d_want = jdense.score_buckets_batched(
        jidx.device_arrays(), jnp.asarray(q), jnp.asarray(q_lens), k=10)
    scores = got.T.copy()
    scores[:, ~live] = -1e30
    order = np.argsort(-scores, axis=1)[:, :10]
    np.testing.assert_array_equal(tb["doc_idx"][order], np.asarray(d_want))
    np.testing.assert_allclose(np.take_along_axis(scores, order, axis=1),
                               np.asarray(v_want), rtol=2e-4, atol=2e-4)
    # and the port's batched scorer takes the same route
    v_got, d_got = tdense.score_buckets_batched(
        tidx.device_arrays("cpu"), torch.from_numpy(q),
        torch.from_numpy(q_lens), k=10)
    np.testing.assert_array_equal(d_got.numpy(), np.asarray(d_want))
    np.testing.assert_allclose(v_got.numpy(), np.asarray(v_want),
                               rtol=2e-4, atol=2e-4)


def test_score_buckets_on_a_bf16_bucket_matches_jax(rng):
    """`score_buckets` (bf16 bucket, one query) against the JAX scorer, by
    either scan name; on the CPU both run the wrappers' plain versions."""
    d, n_docs = 64, 40
    reps = [rng.normal(size=(int(rng.integers(1, 9)), d)).astype(np.float32)
            for _ in range(n_docs)]
    pids = list(range(n_docs))
    jidx = jdense.build_dense_index(reps, pids, buckets=(4, 8))
    tidx = tdense.build_dense_index(reps, pids, buckets=(4, 8))
    q = np.zeros((8, d), np.float32)
    q[:5] = rng.normal(size=(5, d)).astype(np.float32)
    v_want, d_want = jdense.score_buckets(jidx.device_arrays(), jnp.asarray(q),
                                          jnp.int32(5), k=12)
    for scan in ("kernel", "torch"):
        v, dd = tdense.score_buckets(tidx.device_arrays("cpu"),
                                     torch.from_numpy(q), 5, k=12, scan=scan)
        np.testing.assert_array_equal(dd.numpy(), np.asarray(d_want))
        np.testing.assert_allclose(v.numpy(), np.asarray(v_want),
                                   rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="scan must be"):
        tdense.score_buckets(tidx.device_arrays("cpu"), torch.from_numpy(q), 5,
                             k=3, scan="pallas")


def test_launch_counters_stay_at_zero_on_the_cpu(rng):
    assert sk.fused_l2max_scan.launches == 0
    assert sk.fused_l2max_scan_int8_batched.launches == 0


@pytest.mark.parametrize("bsz,qmax,want", [(1, 16, (2, 2, 1, 1)),
                                           (32, 16, (16, 2, 4, 32)),
                                           (3, 16, (8, 2, 1, 4)),
                                           (5, 20, (16, 4, 2, 8)),
                                           (2, 128, (16, 16, 2, 2)),
                                           (1, 3, (2, 2, 1, 1))])
def test_column_tiling_of_the_cuda_launch(bsz, qmax, want):
    """(8-column tiles a group, tiles a query, groups, padded batch): a query
    takes a power of two of columns, 16 at least; a group at most 128."""
    assert sk._tiling(bsz, qmax) == want
    tiles, tiles_q, groups, padded = want
    assert tiles in (2, 4, 8, 16) and tiles % tiles_q == 0 and tiles_q % 2 == 0
    assert padded == groups * (tiles // tiles_q) >= bsz
