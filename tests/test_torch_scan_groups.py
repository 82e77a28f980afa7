"""First-stage scans (K8, K7) past a launch's column budget: a query of more
sentences than `query_cap` (128, or 64 for bf16 and int8 rows wider than
864) is scored in groups of at most that many rows (`query_groups`), and a
query's score is the largest of its groups' (`fold_groups`).  The grouping
code is the same on the CUDA route and the CPU route (where each group runs
the plain version), so these tests hold it: bit for bit against the
ungrouped plain version on integer-valued reps (the score is a maximum, and
every product and sum is then exact, so no summation order -- the CPU's
BLAS picks its kernels by the column count -- can move a bit), then against
the Pallas kernels in interpret mode, which take any padded height, at 130
and 300 query sentences, and the fused single and batched queries against
the JAX package's at 300.

Tolerances against JAX: the scans' of test_torch_scan.py (1e-4 on f32 rows,
2e-4 on int8), the fused queries' of test_torch_fused_query.py (first stage
2e-4, OT 2e-3).
"""
import ml_dtypes
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.index import dense as jdense
from aspire_tpu.index import serve as jserve
from aspire_tpu.ops import pallas_scan as jscan
from aspire_tpu_torch.index import dense as tdense
from aspire_tpu_torch.index import serve as tserve
from aspire_tpu_torch.ops import scan_kernel as sk

from test_torch_scan import _bucket, _int8_bucket


def test_the_query_cap_and_the_groups():
    assert sk.query_cap(torch.bfloat16, 768) == sk.query_cap(torch.int8, 864) == 128
    assert sk.query_cap(torch.bfloat16, 896) == sk.query_cap(torch.int8, 1024) == 64
    assert sk.query_cap(torch.float32, 1024) == 128
    q = torch.arange(2 * 300 * 3, dtype=torch.float32).reshape(2, 300, 3)
    qg, groups = sk.query_groups(q, 128)
    assert groups == 3 and qg.shape == (6, 128, 3)
    assert torch.equal(qg[1, :], q[0, 128:256]) and torch.equal(qg[3, :], q[1, :128])
    assert torch.equal(qg[5, :44], q[1, 256:]) and not qg[5, 44:].any()
    scores = torch.tensor([[1.0, 5.0, 2.0, -3.0, -1.0, -2.0]])
    assert torch.equal(sk.fold_groups(scores, 3), torch.tensor([[5.0, -1.0]]))


def _integers(rng, shape, top=8):
    return np.rint(rng.uniform(-top, top, shape)).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("q_n,qpad,d", [(130, 136, 128), (300, 304, 128),
                                        (300, 300, 896), (20, 300, 128)])
def test_grouped_scan_equals_the_ungrouped_plain_scan(rng, dtype, q_n, qpad, d):
    sents = _integers(rng, (40, 5, d))
    sents[3, 2:] = 0.0
    norms = np.einsum("nsd,nsd->ns", sents, sents).astype(np.float32)
    norms[3, 2:] = np.inf
    sents = torch.from_numpy(sents).to(dtype)
    norms = torch.from_numpy(norms)
    q = torch.from_numpy(_integers(rng, (qpad, d)))
    qadd = -(q * q).sum(dim=1)
    assert qpad > sk.query_cap(dtype, d)
    for add in (None, qadd):
        got = sk.fused_l2max_scan(sents, q, norms, q_n, add)
        want = sk.fused_l2max_scan_plain(sents, q, norms, q_n, add)
        assert torch.equal(got, want)


@pytest.mark.parametrize("qmax,q_lens,d", [(130, [130, 7], 128),
                                           (300, [300, 129, 1], 128),
                                           (300, [300, 65], 1024)])
def test_grouped_int8_batch_equals_the_ungrouped_plain_scan(rng, qmax, q_lens, d):
    _, tidx = _int8_bucket(rng, d, 30, 6)
    b = tidx.buckets[0]
    q = torch.from_numpy(_integers(rng, (len(q_lens), qmax, d)))
    args = (torch.from_numpy(b["sents"]), torch.from_numpy(b["scales"]),
            torch.from_numpy(b["norms"]), q, torch.tensor(q_lens), qmax)
    assert qmax > sk.query_cap(torch.int8, d)
    assert torch.equal(sk.fused_l2max_scan_int8_batched(*args),
                       sk.fused_l2max_scan_int8_batched_plain(*args))


@pytest.mark.parametrize("q_n,qpad", [(130, 136), (300, 304)])
def test_grouped_scan_matches_pallas_kernel(rng, q_n, qpad):
    """f32 rows (the JAX package's own test feeds them), and bf16 rows at
    896 wide, where a group holds 64 query rows."""
    for d, bf16 in ((128, False), (896, True)):
        sents, norms = _bucket(rng, 128, 4, d, all_pad_doc=False)
        if bf16:
            stored = sents.astype(ml_dtypes.bfloat16)
            sents = stored.astype(np.float32)
            norms = np.einsum("nsd,nsd->ns", sents, sents).astype(np.float32)
            norms[(sents == 0).all(axis=2)] = np.inf
        q = np.zeros((qpad, d), np.float32)
        q[:q_n] = rng.normal(size=(q_n, d)).astype(np.float32)
        want = np.asarray(jscan.fused_l2max_scan(
            jnp.asarray(stored if bf16 else sents), jnp.asarray(q),
            jnp.asarray(norms), q_n=q_n, block_docs=128, interpret=True))
        t_sents = torch.from_numpy(sents)
        if bf16:
            t_sents = t_sents.to(torch.bfloat16)
        got = sk.fused_l2max_scan(t_sents, torch.from_numpy(q),
                                  torch.from_numpy(norms), q_n).numpy()
        np.testing.assert_allclose(np.maximum(got, -1e30), np.maximum(want, -1e30),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("qmax,q_lens", [(130, [130, 60]), (300, [300, 140, 3])])
def test_grouped_int8_batch_matches_pallas_kernel(rng, qmax, q_lens):
    d = 128
    jidx, tidx = _int8_bucket(rng, d, 57, 8)
    jb, tb = jidx.buckets[0], tidx.buckets[0]
    q = rng.normal(size=(len(q_lens), qmax, d)).astype(np.float32)
    q_lens = np.asarray(q_lens, np.int32)
    want = np.asarray(jscan.fused_l2max_scan_int8_batched(
        jnp.asarray(jb["sents"]), jnp.asarray(jb["scales"]),
        jnp.asarray(jb["norms"]), jnp.asarray(q), jnp.asarray(q_lens),
        qmax=qmax, interpret=True))
    got = sk.fused_l2max_scan_int8_batched(
        torch.from_numpy(tb["sents"]), torch.from_numpy(tb["scales"]),
        torch.from_numpy(tb["norms"]), torch.from_numpy(q),
        torch.from_numpy(q_lens), qmax).numpy()
    live = tb["doc_idx"] >= 0
    np.testing.assert_allclose(got[live], want[live], rtol=2e-4, atol=2e-4)
    assert (got[~live] <= -0.5e30).all()


DIM, MS = 16, 10


def _indexes(rng, dtype):
    reps = [rng.normal(size=(int(rng.integers(1, MS + 1)), DIM)).astype(np.float32)
            for _ in range(40)]
    pids = [f"p{i}" for i in range(40)]
    jdt = {"bfloat16": ml_dtypes.bfloat16, "int8": "int8"}[dtype]
    j = jdense.build_dense_index(reps, pids, dtype=jdt)
    t = tdense.build_dense_index(reps, pids, dtype=dtype)
    return j, t, ((*jdense.flatten_device_buckets(j.device_arrays()),
                   *j.device_pos_arrays()),
                  (*tdense.flatten_device_buckets(t.device_arrays("cpu")),
                   *t.device_pos_arrays("cpu")))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_fused_queries_of_300_sentences_match_jax(rng, dtype):
    """A single full-text query (300 sentences, three groups) and a batch of
    three, search and OT rerank, against the JAX package's fused queries."""
    j, t, (jargs, targs) = _indexes(rng, dtype)
    int8 = dtype == "int8"
    q = rng.normal(size=(3, 300, DIM)).astype(np.float32)
    q_lens = np.array([300, 181, 2], np.int32)
    for i, n in enumerate(q_lens):
        q[i, n:] = 0
    kw = dict(k=7, max_sents=MS, int8=int8, temp=5.0)
    want = jserve.make_fused_query(len(j.buckets), solver="xla", **kw)(
        jnp.asarray(q[0]), jnp.int32(300), *jargs)
    got = tserve.make_fused_query(len(t.buckets), solver="torch", **kw)(
        torch.from_numpy(q[0]), 300, *targs)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=2e-3, atol=2e-3)
    want_b = jserve.make_fused_query_batched(len(j.buckets), solver="xla", **kw)(
        jnp.asarray(q), jnp.asarray(q_lens), *jargs)
    got_b = tserve.make_fused_query_batched(len(t.buckets), solver="torch", **kw)(
        torch.from_numpy(q), torch.from_numpy(q_lens), *targs)
    np.testing.assert_array_equal(got_b[1].numpy(), np.asarray(want_b[1]))
    np.testing.assert_allclose(got_b[0].numpy(), np.asarray(want_b[0]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_b[2].numpy(), np.asarray(want_b[2]),
                               rtol=2e-3, atol=2e-3)
