"""Sentence pooling (K4): the CUDA kernel's order of f32 additions, written
out in PyTorch (`kernel_order_sums`, as the header of csrc/pool.cu states it),
held against `sentence_pool_pallas` in interpret mode and against the plain
version on the same numpy inputs; and the launch plan, which takes every
(t, max_sents)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.ops.pallas_pool import sentence_pool_pallas
from aspire_tpu_torch.ops import pool_kernel as pk


def kernel_order_sums(hidden: torch.Tensor, sent_ids: torch.Tensor,
                      max_sents: int, warps: int = pk.WARPS) -> torch.Tensor:
    """f32[b, max_sents, h] sums in the kernel's order: warp w takes tokens
    [w C, (w + 1) C), C = ceil(t / warps); a run of equal ids is summed in
    token order and added into the warp's partial when the id changes; the
    partials are added in warp order."""
    b, t, h = hidden.shape
    x = hidden.float()
    chunk = -(-t // warps)
    out = torch.zeros((b, max_sents, h), dtype=torch.float32)
    for e in range(b):
        ids = sent_ids[e].tolist()
        parts = []
        for w in range(warps):
            part = torch.zeros((max_sents, h), dtype=torch.float32)
            cur, run = None, None
            for i in range(min(t, w * chunk), min(t, (w + 1) * chunk)):
                if ids[i] != cur:
                    if cur is not None and 0 <= cur < max_sents:
                        part[cur] += run
                    cur, run = ids[i], x[e, i].clone()
                else:
                    run += x[e, i]
            if cur is not None and 0 <= cur < max_sents:
                part[cur] += run
            parts.append(part)
        acc = parts[0]
        for part in parts[1:]:
            acc = acc + part
        out[e] = acc
    return out


def _runs(rng, b, t, smax):
    """Sentences in runs of random length after [CLS], a padded tail."""
    ids = np.full((b, t), -1, np.int64)
    for e in range(b):
        cuts = np.sort(rng.choice(np.arange(2, t - 4), smax - 1, replace=False))
        bounds = np.concatenate([[1], cuts, [t - 4]])
        for s in range(smax):
            ids[e, bounds[s]:bounds[s + 1]] = s
    return ids


def _ragged(rng, b, t, smax):
    """Ids in no order: gaps, -1 in between, ids past max_sents, one empty."""
    ids = rng.integers(-1, smax + 3, (b, t))
    ids[ids == 3] = -1
    return ids


CASES = {
    "runs": lambda rng: (3, 256, 64, 20, _runs(rng, 3, 256, 20)),
    "ragged": lambda rng: (3, 200, 48, 20, _ragged(rng, 3, 200, 20)),
    # past the 48 KB tile of the first kernel: [96, 128] f32 + 512 ids
    "t512_s96": lambda rng: (2, 512, 32, 96, _runs(rng, 2, 512, 96)),
    "t512_s96_ragged": lambda rng: (2, 512, 32, 96, _ragged(rng, 2, 512, 96)),
    "odd_t": lambda rng: (2, 37, 16, 5, _ragged(rng, 2, 37, 5)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_order_matches_pallas_and_plain(rng, case, dtype):
    b, t, h, smax, ids = CASES[case](rng)
    hidden = torch.from_numpy(rng.normal(size=(b, t, h)).astype(np.float32)
                              ).to(getattr(torch, dtype))
    tids = torch.from_numpy(ids)
    sums = kernel_order_sums(hidden, tids, smax)
    counts = torch.clamp_min(pk._one_hot(tids, smax).sum(dim=1), 1.0)
    got = (sums / counts[:, :, None]).numpy()
    # the Pallas kernel in interpret mode on the same (bf16-exact) f32 values
    want_pl = np.asarray(sentence_pool_pallas(
        jnp.asarray(hidden.float().numpy()), jnp.asarray(ids.astype(np.int32)),
        smax, interpret=True))
    want_plain = pk.sentence_pool_plain(hidden, tids, smax).numpy()
    # f32 sums of up to t values of O(1) in three orders: a few roundings
    np.testing.assert_allclose(got, want_pl, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_plain, rtol=1e-5, atol=1e-5)
    # and the CPU route of the wrapper is the plain version
    np.testing.assert_array_equal(
        pk.sentence_pool_fused(hidden, tids, smax).numpy(), want_plain)


def test_kernel_order_differs_from_token_order_only_by_rounding(rng):
    """One sentence spanning all four chunks: the kernel's sum is the token
    order's up to f32 rounding, and is not always the same bits, so the model
    is the kernel's order and not the old one."""
    t, h = 256, 64
    hidden = torch.from_numpy(rng.normal(size=(1, t, h)).astype(np.float32))
    ids = torch.zeros((1, t), dtype=torch.int64)
    sums = kernel_order_sums(hidden, ids, 1)[0, 0]
    seq = torch.zeros(h)
    for i in range(t):
        seq = seq + hidden[0, i]
    torch.testing.assert_close(sums, seq, rtol=1e-5, atol=1e-5)
    assert not torch.equal(sums, seq)
    chunks = [hidden[0, w * 64:(w + 1) * 64] for w in range(4)]
    parts = []
    for c in chunks:
        run = c[0].clone()
        for row in c[1:]:
            run = run + row
        parts.append(run)
    assert torch.equal(sums, ((parts[0] + parts[1]) + parts[2]) + parts[3])


@pytest.mark.parametrize("h", [768, 1024, 64, 770, 2])
@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("max_sents", [1, 20, 24, 96, 1000])
def test_launch_plan_takes_every_sentence_count(h, size, max_sents):
    """Shared memory within a block's 227 KB (two blocks an SM), every
    sentence in exactly one tile, no empty tile; the width picks the load."""
    for aligned in (True, False):
        vec, stile, tiles = pk.launch_plan(h, max_sents, size, aligned)
        wide = 16 // size
        assert vec == (wide if aligned and h % wide == 0 else 2)
        assert h % vec == 0
        smem = pk.WARPS * stile * 32 * vec * 4
        assert smem <= pk.TILE_BYTES <= 227 * 1024 // 2
        assert 1 <= stile <= max_sents
        assert (tiles - 1) * stile < max_sents <= tiles * stile
    # the encode shape: bf16, 768 wide, 20 sentences in one tile of 16-byte loads
    assert pk.launch_plan(768, 20, 2) == (8, 20, 1)
    assert pk.launch_plan(768, 96, 2) == (8, 24, 4)
