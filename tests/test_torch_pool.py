"""Sentence pooling (K4): `sentence_pool_pallas` in interpret mode and the
JAX einsum against the port's wrapper and its routing, same numpy inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.models.encoders import sentence_pool as j_sentence_pool
from aspire_tpu.ops.pallas_pool import sentence_pool_pallas
from aspire_tpu_torch.models import encoders as tenc
from aspire_tpu_torch.ops import pool_kernel as pk


def _runs(rng, b, t, smax, lo, hi):
    """Sentences in runs after two leading tokens, the last id left empty."""
    sent_ids = np.full((b, t), -1, np.int32)
    for i in range(b):
        pos = 2
        for s in range(smax - 1):
            n = int(rng.integers(lo, hi))
            sent_ids[i, pos:pos + n] = s
            pos += n
    return sent_ids


def _gaps(rng, b, t, smax):
    """Ids in no order: gaps, -1 in between, ids past max_sents, one empty."""
    sent_ids = rng.integers(-1, smax + 2, (b, t)).astype(np.int32)
    sent_ids[sent_ids == 2] = -1
    return sent_ids


CASES = {
    "runs": lambda rng: (3, 32, 128, 6, _runs(rng, 3, 32, 6, 1, 5)),
    "t512_h768": lambda rng: (2, 512, 768, 8, _runs(rng, 2, 512, 8, 20, 60)),
    "gaps": lambda rng: (3, 200, 64, 20, _gaps(rng, 3, 200, 20)),
    "odd_sizes": lambda rng: (5, 37, 48, 3, _gaps(rng, 5, 37, 3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pool_matches_pallas_and_einsum(rng, case):
    b, t, h, smax, sent_ids = CASES[case](rng)
    hidden = rng.normal(size=(b, t, h)).astype(np.float32)
    want_pl = np.asarray(sentence_pool_pallas(
        jnp.asarray(hidden), jnp.asarray(sent_ids), smax, interpret=True))
    want_es = np.asarray(j_sentence_pool(jnp.asarray(hidden),
                                         jnp.asarray(sent_ids), smax))
    th, ti = torch.from_numpy(hidden), torch.from_numpy(sent_ids)
    got = pk.sentence_pool_fused(th, ti, smax)
    assert got.shape == (b, smax, h) and got.dtype == torch.float32
    # f32 sums of up to t values in another order
    np.testing.assert_allclose(got.numpy(), want_pl, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_es, rtol=1e-5, atol=1e-5)
    for impl in ("auto", "fused", "naive"):
        with torch.no_grad():
            routed = tenc.sentence_pool(th, ti, smax, impl)
        np.testing.assert_allclose(routed.numpy(), want_es, rtol=1e-5, atol=1e-5)


def test_pool_bf16_hidden_and_int64_ids(rng):
    b, t, h, smax = 2, 40, 32, 5
    sent_ids = _runs(rng, b, t, smax, 2, 8)
    hidden = torch.from_numpy(rng.normal(size=(b, t, h)).astype(np.float32)
                              ).to(torch.bfloat16)
    want = np.asarray(j_sentence_pool(jnp.asarray(hidden.float().numpy()),
                                      jnp.asarray(sent_ids), smax))
    got = pk.sentence_pool_fused(hidden, torch.from_numpy(sent_ids).long(), smax)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (got[:, smax - 1] == 0).all()        # no token: a zero vector


def test_pool_routing_under_grad(rng):
    """Under grad the plain product runs and carries the gradient; 'fused'
    refuses; unknown names are refused."""
    b, t, h, smax = 2, 16, 8, 3
    sent_ids = torch.from_numpy(_runs(rng, b, t, smax, 2, 5))
    hidden = torch.from_numpy(rng.normal(size=(b, t, h)).astype(np.float32)
                              ).requires_grad_(True)
    before = pk.sentence_pool_fused.launches
    out = tenc.sentence_pool(hidden, sent_ids, smax)
    out.sum().backward()
    counts = (sent_ids[:, :, None] == torch.arange(smax)).sum(1).clamp_min(1)
    want = torch.where(sent_ids >= 0,
                       1.0 / counts.gather(1, sent_ids.clamp_min(0).long()), 0.0)
    np.testing.assert_allclose(hidden.grad.numpy(),
                               want[:, :, None].expand(b, t, h).numpy(),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="no backward"):
        tenc.sentence_pool(hidden, sent_ids, smax, "fused")
    with pytest.raises(ValueError, match="unknown pool_impl"):
        tenc.sentence_pool(hidden, sent_ids, smax, "pallas")
    assert pk.sentence_pool_fused.launches == before   # no launch on the CPU


def test_kernel_entry_refuses_cpu_tensors(rng):
    hidden = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        pk.sentence_sums(hidden, torch.zeros((1, 4), dtype=torch.int32), 2)


def test_encoder_takes_pool_impl(rng):
    from aspire_tpu_torch.models.bert import BertConfig
    cfg = BertConfig.tiny()
    tok = torch.from_numpy(rng.integers(5, cfg.vocab_size, (2, 16)))
    mask = torch.ones((2, 16), dtype=torch.int64)
    sent = torch.from_numpy(_runs(rng, 2, 16, 3, 2, 5)).long()
    torch.manual_seed(0)
    enc = tenc.ConSentEncoder(cfg, max_sents=3, device="cpu").eval()
    outs = []
    for impl in ("auto", "fused", "naive"):
        enc.pool_impl = impl
        with torch.no_grad():
            outs.append(enc(tok, mask, sent)[1])
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(outs[0], outs[2], rtol=1e-6, atol=1e-6)
