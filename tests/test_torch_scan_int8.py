"""The int8 batched scan (K7) as csrc/scan_int8.cu computes it, written out
in numpy and PyTorch: the int8 -> bf16 upcast by integer and FP32-pipe
instructions, bit for bit for all 256 values; the k order in which a thread's
16 bytes are its A fragments, and the query laid out in that order, held
against `fused_l2max_scan_int8_batched` in interpret mode on the same numpy
inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.ops import pallas_scan as jscan
from aspire_tpu_torch.ops import scan_kernel as sk


def byte_perm(x: np.ndarray, y, sel: int) -> np.ndarray:
    """PTX prmt (default mode, CUDA's __byte_perm): byte n of the result is
    byte (sel >> 4 n) & 7 of the eight bytes y:x (x the low four)."""
    pair = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(x, np.uint64)
    out = np.zeros(np.shape(x), np.uint64)
    for n in range(4):
        b = (sel >> (4 * n)) & 7
        out |= ((pair >> np.uint64(8 * b)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(np.uint32)


def int8x4_to_bf16x2(word: np.ndarray):
    """common.cuh's int8x4_to_bf16x2, instruction by instruction."""
    u = word ^ np.uint32(0x80808080)
    f = [byte_perm(u, 0x4B000000, 0x7440 + i).view(np.float32) - np.float32(8388736.0)
         for i in range(4)]
    lo = byte_perm(f[0].view(np.uint32), f[1].view(np.uint32), 0x7632)
    hi = byte_perm(f[2].view(np.uint32), f[3].view(np.uint32), 0x7632)
    return lo, hi


def test_upcast_by_bit_tricks_is_exact_for_every_int8():
    values = np.arange(-128, 128, dtype=np.int8)
    want = (torch.from_numpy(values).to(torch.bfloat16).view(torch.int16)
            .numpy().view(np.uint16))
    rng = np.random.default_rng(0)
    for pos in range(4):
        b = rng.integers(-128, 128, (256, 4)).astype(np.int8)
        b[:, pos] = values
        word = b.view(np.uint32)[:, 0]
        lo, hi = int8x4_to_bf16x2(word)
        halves = np.stack([lo & 0xFFFF, lo >> 16, hi & 0xFFFF, hi >> 16], axis=1)
        np.testing.assert_array_equal(halves[:, pos].astype(np.uint16), want)
        # every byte of the word lands in its own half: lo = bytes 0, 1; hi = 2, 3
        bf = (torch.from_numpy(b.astype(np.float32)).to(torch.bfloat16)
              .view(torch.int16).numpy().view(np.uint16))
        np.testing.assert_array_equal(halves.astype(np.uint16), bf)


@pytest.mark.parametrize("dp", [64, 128, 832])
def test_k_order_puts_a_threads_bytes_where_its_fragments_read(dp):
    """Thread t of a quad reads bytes 16 t .. 16 t + 15 of a row's 64-wide
    stage; word j of them is step j's A registers a0 (columns 2t, 2t+1) and a2
    (2t+8, 2t+9), so logical column 16 j + l must hold that byte."""
    order = sk.int8_k_order(dp).numpy()
    assert sorted(order.tolist()) == list(range(dp))
    for c in range(dp // 64):
        for t in range(4):
            for j in range(4):
                for e, l in enumerate((2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)):
                    assert order[64 * c + 16 * j + l] == 64 * c + 16 * t + 4 * j + e


def _kernel_model(sents, scales, norms, q, q_lens, qmax):
    """The scan as the CUDA kernel lays it out: the rows as stored, padded to
    a multiple of 64 and read in the k order its fragments give (`a`), the
    query through `int8_query_layout`, products of the exact bf16 operands in
    float64, then rs * acc + rb + qadd and the maxima."""
    n, s, d = sents.shape
    bsz = q.shape[0]
    qb = q.to(torch.bfloat16)                                    # never quantised
    qk = sk.int8_query_layout(qb.reshape(bsz * qmax, d))
    dp = qk.shape[1]
    order = sk.int8_k_order(dp)
    rows = torch.nn.functional.pad(sents.reshape(n * s, d), (0, dp - d))
    a = rows.to(torch.bfloat16)[:, order]                        # exact
    acc = a.double() @ qk.double().t()
    # the permutation changes no product
    plain = sents.reshape(n * s, d).double() @ qb.double().reshape(bsz * qmax, d).t()
    torch.testing.assert_close(acc, plain, rtol=1e-12, atol=1e-9)
    qf = q.float()
    valid = torch.arange(qmax)[None, :] < q_lens[:, None]
    qadd = torch.where(valid, -(qf * qf).sum(2), torch.full((bsz, qmax), sk.NEG))
    rs = (2.0 * scales).reshape(-1, 1).double()
    rb = torch.where(torch.isfinite(norms), -norms,
                     torch.full_like(norms, sk.NEG)).reshape(-1, 1).double()
    scores = rs * acc + rb + qadd.reshape(1, -1).double()
    return scores.reshape(n, s, bsz, qmax).amax(dim=(1, 3)).float()


@pytest.mark.parametrize("n,s,d,bsz,qmax", [(40, 12, 128, 4, 16),
                                            (64, 7, 96, 3, 5),
                                            (20, 24, 64, 1, 16),
                                            (32, 5, 160, 5, 20)])
def test_permuted_operands_give_the_pallas_kernel_scores(rng, n, s, d, bsz, qmax):
    sents = rng.integers(-127, 128, (n, s, d)).astype(np.int8)
    pad = rng.random((n, s)) < 0.25
    pad[n // 2] = True                                            # a doc of pads
    sents[pad] = 0
    scales = np.where(pad, 0.0, rng.uniform(0.005, 0.03, (n, s))).astype(np.float32)
    norms = (sents.astype(np.float32) ** 2).sum(2) * scales * scales
    norms[pad] = np.inf
    q = rng.normal(size=(bsz, qmax, d)).astype(np.float32)
    q_lens = rng.integers(1, qmax + 1, bsz).astype(np.int32)
    got = _kernel_model(torch.from_numpy(sents), torch.from_numpy(scales),
                        torch.from_numpy(norms), torch.from_numpy(q),
                        torch.from_numpy(q_lens), qmax).numpy()
    want = np.asarray(jscan.fused_l2max_scan_int8_batched(
        jnp.asarray(sents), jnp.asarray(scales), jnp.asarray(norms),
        jnp.asarray(q), jnp.asarray(q_lens), qmax=qmax, interpret=True))
    live = ~pad.all(axis=1)
    # float64 against the Pallas kernel's f32 sums of up to d products
    np.testing.assert_allclose(got[live], want[live], rtol=2e-4, atol=2e-4)
    assert (got[~live] <= -0.5e30).all() and (want[~live] <= -0.5e30).all()
    plain = sk.fused_l2max_scan_int8_batched_plain(
        torch.from_numpy(sents), torch.from_numpy(scales), torch.from_numpy(norms),
        torch.from_numpy(q), torch.from_numpy(q_lens), qmax).numpy()
    np.testing.assert_allclose(got[live], plain[live], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bsz,qmax,d,wide", [(32, 16, 768, True), (1, 16, 768, False),
                                             (5, 20, 768, True), (4, 16, 768, False),
                                             (8, 16, 768, True), (2, 64, 768, True),
                                             (32, 16, 800, False), (40, 16, 96, True)])
def test_int8_batches_go_to_the_wide_kernel_by_shape(bsz, qmax, d, wide):
    """Full column groups (128 columns) at D up to 768 run csrc/scan_int8.cu,
    whose group of [128, D] bf16 query rows stays in shared memory beside
    three 8 KB row stages, a tile's row maxima [128, 8], the unit's maxima
    [64, 8] and the barriers, within a block's 227 KB; the rest run
    csrc/scan.cu."""
    assert sk.scan_wide(bsz, qmax, d) is wide
    assert wide == (sk._tiling(bsz, qmax)[0] == sk.MAX_TILES and d <= 768)
    dp = -(-d // 64) * 64
    smem = 1024 + 128 * dp * 2 + 3 * 8192 + 128 * 8 * 4 + 64 * 8 * 4 + 7 * 8
    assert smem <= 232448 or not wide
    with pytest.raises(ValueError, match="query sentences"):
        sk._launch("aspire_scan_int8", torch.zeros((1, 1, d), dtype=torch.int8),
                   torch.zeros((1, 1)), torch.zeros((1, 1)),
                   torch.zeros((1, 129, d)), torch.zeros((1, 129)))


@pytest.mark.parametrize("d,tiles", [(768, 16), (864, 16), (896, 8), (1024, 8)])
def test_narrow_groups_fit_a_blocks_shared_memory(d, tiles):
    """csrc/scan.cu keeps a group's [8 tiles, D + 32] bf16 query rows in shared
    memory: past D = 864 a group holds 8 tiles, and a query at most 64
    sentences (a launch there used to be refused by the card)."""
    assert sk._max_tiles(d) == tiles
    assert sk._tiling(2, 64, tiles) == ((16, 8, 1, 2) if tiles == 16 else (8, 8, 2, 2))
    if tiles == 8:
        with pytest.raises(ValueError, match="up to 64 query sentences"):
            sk._launch("aspire_scan_int8", torch.zeros((1, 1, d), dtype=torch.int8),
                       torch.zeros((1, 1)), torch.zeros((1, 1)),
                       torch.zeros((1, 65, d)), torch.zeros((1, 65)))
