"""The wide scan kernel (csrc/scan_int8.cu) on ragged query batches, on the
card: its packed columns (`pack_kernel`, from the lengths on the device)
give the plain versions' scores on both epilogues -- documents of 12 rows
(the short one) and full-text documents of 1,200 (the long one) -- and the
`scan` span's `columns` and `sentences` counts are those of `pack_plan`.
Without a CUDA device every case skips.  The file imports no JAX, so that a
machine with the card and without JAX runs it (tests/conftest.py sets JAX
up, hence no conftest):

    python -m pytest --noconftest -m card tests/test_torch_scan_packed_card.py
"""
import numpy as np
import pytest
import torch

from aspire_tpu_torch.ops import scan_kernel as sk
from aspire_tpu_torch.utils import profiling


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bucket(rng, dev, n, s, d):
    lens = rng.integers(0, s + 1, n)
    live = torch.from_numpy(np.arange(s)[None, :] < lens[:, None]).to(dev)
    sents = torch.from_numpy(rng.integers(-127, 128, (n, s, d)).astype(np.int8)).to(dev)
    sents = sents * live[:, :, None]
    scales = torch.from_numpy(rng.uniform(0.005, 0.03, (n, s)).astype(np.float32)).to(dev)
    scales = torch.where(live, scales, torch.zeros_like(scales))
    norms = (sents.float() ** 2).sum(2) * scales * scales
    norms = torch.where(live, norms, torch.full_like(norms, torch.inf))
    return sents.contiguous(), scales.contiguous(), norms.contiguous(), live.any(dim=1)


@pytest.mark.card
@pytest.mark.parametrize("n,s,bsz,qmax,lens", [
    (3000, 12, 32, 24, "b32"),                   # the short epilogue, abstracts' queries
    (1500, 24, 32, 24, "ragged"),
    (2000, 12, 32, 16, "full"),                  # today's layout, column for column
    (40, 1200, 8, 300, "ragged"),                # the long epilogue: groups of 64 and tails
])
def test_packed_wide_scan_equals_the_plain_scan(n, s, bsz, qmax, lens):
    dev = _card()
    rng = np.random.default_rng(n + s + qmax)
    d = 768
    sents, scales, norms, live = _bucket(rng, dev, n, s, d)
    if lens == "b32":
        q_lens = np.clip(rng.poisson(9, bsz), 3, 20)
    elif lens == "full":
        q_lens = np.full(bsz, qmax)
    else:
        q_lens = rng.integers(0, qmax + 1, bsz)
        q_lens[:3] = [1, qmax, 9]
    q = torch.from_numpy(rng.normal(size=(bsz, qmax, d)).astype(np.float32) * 2).to(dev)
    ql = torch.from_numpy(q_lens).to(dev)
    before = sk.fused_l2max_scan_int8_batched.wide_launches
    with profiling.recording(), profiling.span("scan"):
        got = sk.fused_l2max_scan_int8_batched(sents, scales, norms, q, ql, qmax)
    (rec,) = profiling.records()
    profiling.reset()
    assert sk.fused_l2max_scan_int8_batched.wide_launches == before + 1
    want = sk.fused_l2max_scan_int8_batched_plain(sents, scales, norms, q, ql, qmax)
    torch.testing.assert_close(got[live], want[live], rtol=2e-4, atol=2e-4)
    assert bool((got[~live] <= 0.5 * sk.NEG).all())
    rows, groups = sk.int8_groups(qmax, d)
    lens_g = (np.minimum(q_lens, qmax)[:, None] - rows * np.arange(groups)).clip(0, rows)
    unit = sk.pack_unit(sk.launch_plan(torch.int8, n, s, d, bsz * groups, rows), s)
    plan = sk.pack_plan(lens_g.reshape(-1).tolist(), rows, unit)
    assert rec["counts"] == {"columns": 128 * len(plan), "sentences": int(lens_g.sum())}


@pytest.mark.card
@pytest.mark.parametrize("q_n", [300, 257, 100])
def test_packed_bf16_wide_scan_equals_the_plain_scan(q_n):
    """K8 on the wide kernel: a query of 65 or more sentences, its groups of
    128 packed from their lengths."""
    dev = _card()
    rng = np.random.default_rng(q_n)
    n, s, d = 60, 300, 768
    sents, _, norms, live = _bucket(rng, dev, n, s, d)
    rows = sents.to(torch.bfloat16)
    norms = torch.where(torch.isfinite(norms), (rows.float() ** 2).sum(2), norms)
    q = torch.from_numpy(rng.normal(size=(304, d)).astype(np.float32)).to(dev)
    qadd = -(q * q).sum(1)
    before = sk.fused_l2max_scan.wide_launches
    got = sk.fused_l2max_scan(rows, q, norms, q_n, qadd)
    assert sk.fused_l2max_scan.wide_launches == before + 1
    want = sk.fused_l2max_scan_plain(rows, q, norms, q_n, qadd)
    torch.testing.assert_close(got[live], want[live], rtol=2e-4, atol=2e-4)
    assert bool((got[~live] == -torch.inf).all())


@pytest.mark.card
@pytest.mark.parametrize("s,bsz,qmax,lens", [(12, 32, 24, "b32"), (12, 32, 24, "ragged"),
                                             (12, 32, 16, "full"), (12, 5, 20, "ragged"),
                                             (12, 40, 4, "ragged"), (300, 8, 64, "ragged")])
def test_pack_kernel_equals_the_plain_packing(s, bsz, qmax, lens):
    """`pack_kernel`'s packed query, qadd and plan over the live groups equal
    `pack_queries_plain`'s, bit for bit, in units of 4 columns (documents of
    12 rows: the short epilogue; 40 queries of 1-4 sentences fill groups
    with 16 queries) and of 8 (full-text rows: the long one), and a launch
    into these buffers gives the wrapper's scores bit for bit."""
    dev = _card()
    rng = np.random.default_rng(bsz + qmax)
    n, d = 6000 // s, 768
    sents, scales, norms, _ = _bucket(rng, dev, n, s, d)
    if lens == "b32":
        q_lens = np.clip(rng.poisson(9, bsz), 3, 20)
    elif lens == "full":
        q_lens = np.full(bsz, qmax)
    else:
        q_lens = rng.integers(0, qmax + 1, bsz)
    q = torch.from_numpy(rng.normal(size=(bsz, qmax, d)).astype(np.float32) * 2).to(dev)
    ql = torch.from_numpy(q_lens).to(dev)
    qadd = -(q * q).sum(dim=2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    launch = sk.launch_plan(torch.int8, n, s, d, bsz, qmax, sms)
    scratch = sk.pack_buffers(launch.groups, d, dev)
    got = sk._launch("aspire_scan_int8", sents, scales, norms, q, qadd, ql, scratch)
    packed, qa, plan = (t.cpu() for t in scratch)
    want_packed, want_qa, want_plan = sk.pack_queries_plain(
        q.cpu(), qadd.cpu(), q_lens, unit=sk.pack_unit(launch, s))
    cols = int(want_plan[1])
    assert torch.equal(plan[:want_plan.numel()], want_plan)
    assert torch.equal(packed[:cols], want_packed)
    assert torch.equal(qa[:cols], want_qa)
    assert torch.equal(got, sk.fused_l2max_scan_int8_batched(sents, scales, norms, q, ql, qmax))
