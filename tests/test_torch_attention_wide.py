"""Heads wider than 64 columns: the wrapper pads a head of width 64 < hd <=
256 to the next multiple of 64 (`head_route`) and a CUDA tensor runs the
kernels of csrc/attention.cu and csrc/attention_bwd.cu at that width, bf16
and f32.  Here the pad and slice run around the
plain version, forward and ordinary autograd backward, against the JAX
package's fused_dropout_attention (Pallas forward and backward in interpret
mode, which takes whole heads of any width) at hd 96, 128 and 256, with
padded keys, a fully padded row, p = 0 and p = 0.1 with explicit bits; then
a 2-layer encoder with 128-wide heads against the JAX BertModel on carried
weights.

float32 atol 1e-5: another summation order and exp routine.  bfloat16 atol
2e-2: each output is rounded to bf16 once on each side, and autograd of the
plain version rounds the probabilities' cotangent to bf16 where the Pallas
backward keeps it in f32 (test_torch_attention_narrow.py's tolerances).  That
cotangent, g . v^T, grows as sqrt(hd), so the bf16 gradients also get a
relative 2e-2 (chip_smoke.py's limits for the bf16 backward).  The encoder:
atol 1e-4 in float32 (test_torch_bert.py's).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.models import bert as jb
from aspire_tpu.ops.pallas_attention import fused_dropout_attention
from aspire_tpu_torch.models import bert as tb
from aspire_tpu_torch.models.convert import state_dict_from_flax_params
from aspire_tpu_torch.ops.attention_kernel import (HEAD_DIM, WIDE_MAX,
                                                   attention_keep_mask,
                                                   fused_attention,
                                                   fused_attention_plain,
                                                   head_route,
                                                   with_padded_heads)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
B, NH, T = 3, 2, 16


def _case(rng, hd):
    q, k, v, g = (rng.standard_normal((B, NH, T, hd)).astype(np.float32)
                  for _ in range(4))
    keep = np.ones((B, T), bool)
    keep[1, T // 2 + 1:] = False        # padded keys
    keep[2, :] = False                  # a fully padded row: uniform probs
    bias = np.where(keep, 0.0, -1e9).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, (B, NH, T, T), dtype=np.uint32)
    return q, k, v, g, bias, bits


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("hd", [96, 128, 256])
def test_padded_plain_attention_matches_pallas_at_wide_heads(rng, dtype, p, hd):
    jd, td, atol = DTYPES[dtype]
    q, k, v, g, bias, bits = _case(rng, hd)
    scale = 1.0 / np.sqrt(hd)

    def jax_out(qj, kj, vj):
        return fused_dropout_attention(
            qj, kj, vj, jnp.asarray(bias), jnp.zeros((1,), jnp.uint32),
            dropout_p=p, sm_scale=float(scale),
            rng_bits=jnp.asarray(bits) if p > 0 else None, interpret=True)

    want, vjp = jax.vjp(jax_out, *(jnp.asarray(a, jd) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(g, jd))

    keep = None
    if p > 0:
        keep = attention_keep_mask((B, NH, T, hd), p,
                                   rng_bits=torch.from_numpy(bits.view(np.int32)))
    leaves = [torch.from_numpy(a).to(td).requires_grad_(True) for a in (q, k, v)]
    seen = []

    def at_kernel_width(q_, k_, v_, *args):
        seen.append(q_.shape[-1])
        return fused_attention_plain(q_, k_, v_, *args)

    got = with_padded_heads(at_kernel_width, *leaves, torch.from_numpy(bias),
                            float(scale), p, keep)
    assert seen == [head_route(hd)[0]]
    assert got.shape == (B, NH, T, hd) and got.dtype == td
    got.backward(torch.from_numpy(g).to(td))
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol)
    for name, leaf, w in zip(("dq", "dk", "dv"), leaves, want_grads):
        assert leaf.grad.shape == (B, NH, T, hd)
        np.testing.assert_allclose(leaf.grad.float().numpy(),
                                   np.asarray(w, np.float32), atol=atol,
                                   rtol=0.0 if dtype == "float32" else 2e-2,
                                   err_msg=name)


@pytest.mark.parametrize("hd", [96, 200])
def test_wide_padding_changes_nothing_in_float32(rng, hd):
    """The pad to 128 (or 256) is exact: padded-then-sliced equals the plain
    version at the head's own width, forward and gradients, up to the
    product's summation order."""
    q, k, v, g, bias, bits = _case(rng, hd)
    keep = attention_keep_mask((B, NH, T, hd), 0.1,
                               rng_bits=torch.from_numpy(bits.view(np.int32)))
    outs = []
    for pad in (True, False):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        args = (torch.from_numpy(bias), 1.0 / np.sqrt(hd), 0.1, keep)
        out = (with_padded_heads(fused_attention_plain, *leaves, *args) if pad
               else fused_attention_plain(*leaves, *args))
        out.backward(torch.from_numpy(g))
        outs.append([out.detach()] + [x.grad for x in leaves])
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def test_the_width_route():
    """Up to 64 the 64-wide kernels, above them the wide ones at the next
    multiple of 64 up to WIDE_MAX; wider heads are refused by name."""
    assert [head_route(h) for h in (1, 8, 32, HEAD_DIM)] == [(64, "narrow")] * 4
    assert [head_route(h) for h in (65, 96, 128, 129, 192, 200, 256)] == [
        (128, "wide"), (128, "wide"), (128, "wide"), (192, "wide"),
        (192, "wide"), (256, "wide"), (256, "wide")]
    assert WIDE_MAX == 256
    for bad in (0, WIDE_MAX + 1, 512):
        with pytest.raises(ValueError, match=str(bad)):
            head_route(bad)


def test_the_cpu_route_takes_any_width(rng):
    """The plain version on a CPU tensor, whatever the width (the card raises
    past WIDE_MAX)."""
    q = torch.from_numpy(rng.standard_normal((1, 2, 4, 320)).astype(np.float32))
    out = fused_attention(q, q, q, torch.zeros((1, 4)), 0.1)
    assert out.shape == q.shape


@pytest.mark.parametrize("hidden,heads", [(256, 2), (192, 2)],
                         ids=["hd128", "hd96"])
def test_encoder_with_wide_heads_matches_flax(rng, hidden, heads):
    """BertModel at 2 layers with heads of 128 (and 96) through the port's
    attention route ('fused_det': the kernels' plain version on the CPU)
    against the JAX BertModel on carried weights, every hidden state."""
    kw = dict(hidden_size=hidden, num_attention_heads=heads,
              intermediate_size=2 * hidden)
    cfg = jb.BertConfig.tiny(**kw)
    tok = rng.integers(5, cfg.vocab_size, (B, 40)).astype(np.int32)
    mask = np.ones((B, 40), np.int32)
    mask[1, 29:] = 0
    mask[2, 11:] = 0
    typ = rng.integers(0, 2, (B, 40)).astype(np.int32)
    jm = jb.BertModel(cfg)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        jm.init(jax.random.key(0), tok, mask, typ)["params"])
    last_j, hs_j = jm.apply({"params": params}, tok, mask, typ)
    tm = tb.BertModel(tb.BertConfig.tiny(**kw), attention_impl="fused_det",
                      device="cpu")
    tm.load_state_dict(state_dict_from_flax_params(params, cfg))
    with torch.inference_mode():
        last_t, hs_t = tm.eval()(*(torch.from_numpy(a).long() for a in (tok, mask, typ)))
    assert len(hs_t) == len(hs_j) == cfg.num_hidden_layers + 1
    for h_t, h_j in zip(hs_t, hs_j):
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=1e-4)
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j), atol=1e-4)
