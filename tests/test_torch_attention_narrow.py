"""Heads narrower than the kernels' 64 columns: the wrapper zero-pads q, k, v
to 64 columns and slices the output back (`with_padded_heads`), which is
what a CUDA tensor of BertConfig.tiny() (hd 8) goes through.  Here the pad and
slice run around the plain version, forward and ordinary autograd backward,
against the JAX package's fused_dropout_attention (Pallas forward and backward
in interpret mode) at the narrow width itself, with padded keys, a fully
padded row, p = 0 and p = 0.1 with explicit bits.

float32 atol 1e-5: another summation order and exp routine.  bfloat16 atol
2e-2: each output is rounded to bf16 once on each side, and autograd of the
plain version rounds the probabilities' cotangent to bf16 where the Pallas
backward keeps it in f32 (the tolerances of test_torch_attention_train.py).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.ops.pallas_attention import fused_dropout_attention
from aspire_tpu_torch.ops.attention_kernel import (HEAD_DIM,
                                                   attention_keep_mask,
                                                   fused_attention,
                                                   fused_attention_plain,
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
@pytest.mark.parametrize("hd", [8, 32])
def test_padded_plain_attention_matches_pallas_at_the_narrow_width(rng, dtype, p, hd):
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
    got = with_padded_heads(fused_attention_plain, *leaves,
                            torch.from_numpy(bias), float(scale), p, keep)
    assert got.shape == (B, NH, T, hd) and got.dtype == td
    got.backward(torch.from_numpy(g).to(td))
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol)
    for name, leaf, w in zip(("dq", "dk", "dv"), leaves, want_grads):
        assert leaf.grad.shape == (B, NH, T, hd)
        np.testing.assert_allclose(leaf.grad.float().numpy(),
                                   np.asarray(w, np.float32), atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("hd", [8, 32])
def test_padding_changes_nothing_in_float32(rng, hd):
    """The pad is exact: padded-then-sliced equals the plain version at the
    narrow width, forward and gradients, up to the product's summation order."""
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


def test_full_width_is_passed_through_and_wider_heads_are_not_padded(rng):
    q = torch.zeros((1, 1, 4, HEAD_DIM))
    seen = []
    with_padded_heads(lambda *a: seen.append(a[0]) or a[0], q, q, q)
    assert seen[0] is q
    # the CPU route takes any width; on a CUDA tensor a head of 64 < hd <= 256
    # is padded to the next multiple of 64 for the wide kernels (head_route)
    wide = torch.from_numpy(rng.standard_normal((1, 2, 4, 80)).astype(np.float32))
    out = fused_attention(wide, wide, wide, torch.zeros((1, 4)), 0.1)
    assert out.shape == wide.shape
