"""Port parity: the plain version of the CUDA FFN kernel (what the wrapper
runs on CPU tensors) against the JAX package's Pallas kernel in interpret
mode."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.ops.pallas_ffn import fused_ffn as j_fused_ffn
from aspire_tpu_torch.ops.ffn_kernel import fused_ffn, fused_ffn_plain


def _rand(rng, rows, h, f):
    mk = lambda *s: (rng.normal(size=s) * 0.1).astype(np.float32)
    return (rng.normal(size=(rows, h)).astype(np.float32),
            mk(h, f), mk(f), mk(f, h), mk(h))


@pytest.mark.parametrize("rows,h,f,dtype,atol", [
    # f32: the Pallas kernel's erf is the A&S 7.1.26 polynomial (1.5e-7)
    # where the port uses the exact erf, plus summation order
    (40, 32, 128, "float32", 1e-4),
    (7, 16, 64, "float32", 1e-4),        # ragged: fewer rows than any block
    (33, 32, 128, "float32", 1e-4),      # ragged: odd rows
    # bf16: activation and output each rounded to bf16 (ulp 2^-7 at O(1))
    (33, 32, 128, "bfloat16", 5e-2),
    (64, 64, 256, "bfloat16", 5e-2),
])
def test_plain_ffn_matches_pallas_interpret(rng, rows, h, f, dtype, atol):
    arrs = _rand(rng, rows, h, f)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = fused_ffn(*(torch.from_numpy(a).to(tdt) for a in arrs))
    assert got.dtype == tdt and got.shape == (rows, h)
    want = j_fused_ffn(*(jnp.asarray(a, jdt) for a in arrs), interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol)


def test_leading_dimensions_are_kept(rng):
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _rand(rng, 12, 16, 64))
    got = fused_ffn(x.reshape(3, 4, 16), w1, b1, w2, b2)
    assert got.shape == (3, 4, 16)
    np.testing.assert_array_equal(got.reshape(12, 16).numpy(),
                                  fused_ffn_plain(x, w1, b1, w2, b2).numpy())


def test_forward_only_and_shape_checks(rng):
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _rand(rng, 8, 16, 64))
    before = fused_ffn.launches
    fused_ffn(x, w1, b1, w2, b2)
    assert fused_ffn.launches == before        # CPU tensors launch nothing
    # under grad the split runs the plain composition and is differentiable
    xg = x.clone().requires_grad_(True)
    fused_ffn(xg, w1, b1, w2, b2).sum().backward()
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())
    with torch.no_grad():
        out = fused_ffn(x.clone().requires_grad_(True), w1, b1, w2, b2)
    assert not out.requires_grad
    with pytest.raises(TypeError, match="dtype"):
        fused_ffn(xg, w1.double(), b1, w2, b2)
    with pytest.raises(ValueError, match="FFN"):
        fused_ffn(x, w1.t(), b1, w2, b2)
