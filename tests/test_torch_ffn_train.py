"""Port parity: the grad-enabled split of ops/ffn_kernel.fused_ffn against
jax.grad of the JAX package's fused_ffn (whose custom_vjp runs the plain
composition forward and the five-product backward): output and all five
gradients on the same numpy inputs.

float32 atol 1e-4: sums of up to 64 terms in another order, and the JAX side's
polynomial erf (|err| <= 1.5e-7) against the exact one here.  bfloat16: each
product's output is rounded once on either side (atol 5e-2 on O(1) values).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aspire_tpu.ops.pallas_ffn import fused_ffn as jax_ffn
from aspire_tpu_torch.ops.ffn_kernel import fused_ffn, fused_ffn_plain

NAMES = ("x", "w1", "b1", "w2", "b2")


def _rand(rng, rows, h, f):
    return (rng.standard_normal((rows, h)).astype(np.float32),
            (rng.standard_normal((h, f)) * 0.3).astype(np.float32),
            (rng.standard_normal(f) * 0.3).astype(np.float32),
            (rng.standard_normal((f, h)) * 0.3).astype(np.float32),
            (rng.standard_normal(h) * 0.3).astype(np.float32))


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("rows", [16, 11])
def test_output_and_five_gradients_match_jax_grad(rng, dtype, atol, rows):
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    arrays = _rand(rng, rows, 16, 64)
    g = rng.standard_normal((rows, 16)).astype(np.float32)

    want, vjp = jax.vjp(lambda *a: jax_ffn(*a, interpret=True),
                        *(jnp.asarray(a, jd) for a in arrays))
    want_grads = vjp(jnp.asarray(g, jd))

    leaves = [torch.from_numpy(a).to(td).requires_grad_(True) for a in arrays]
    got = fused_ffn(*leaves)
    got.backward(torch.from_numpy(g).to(td))
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol)
    for name, leaf, wg in zip(NAMES, leaves, want_grads):
        assert leaf.grad.dtype == td and leaf.grad.shape == leaf.shape
        np.testing.assert_allclose(leaf.grad.float().numpy(),
                                   np.asarray(wg, np.float32).reshape(leaf.shape),
                                   atol=atol * max(1.0, rows / 4), err_msg=name)


def test_split_agrees_with_autograd_of_the_plain_version(rng):
    arrays = _rand(rng, 12, 16, 64)
    g = torch.from_numpy(rng.standard_normal((12, 16)).astype(np.float32))
    a = [torch.from_numpy(x).requires_grad_(True) for x in arrays]
    b = [torch.from_numpy(x).requires_grad_(True) for x in arrays]
    fused_ffn(*a).backward(g)
    fused_ffn_plain(*b).backward(g)
    for name, x, y in zip(NAMES, a, b):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), atol=1e-5,
                                   err_msg=name)


def test_transposed_weight_views_and_leading_shapes(rng):
    """The model hands fused_ffn transposed views of [out, in] parameters."""
    x, w1, b1, w2, b2 = _rand(rng, 12, 16, 64)
    p1 = torch.from_numpy(w1.T.copy()).requires_grad_(True)     # [f, h] as nn.Linear
    p2 = torch.from_numpy(w2.T.copy()).requires_grad_(True)
    xt = torch.from_numpy(x).reshape(3, 4, 16).requires_grad_(True)
    out = fused_ffn(xt, p1.t(), torch.from_numpy(b1), p2.t(), torch.from_numpy(b2))
    assert out.shape == (3, 4, 16)
    out.sum().backward()
    ref = [torch.from_numpy(a).requires_grad_(True) for a in (x, w1, b1, w2, b2)]
    fused_ffn(*ref).sum().backward()
    np.testing.assert_allclose(p1.grad.numpy(), ref[1].grad.numpy().T, atol=1e-6)
    np.testing.assert_allclose(p2.grad.numpy(), ref[3].grad.numpy().T, atol=1e-6)
    np.testing.assert_allclose(xt.grad.reshape(12, 16).numpy(),
                               ref[0].grad.numpy(), atol=1e-6)


def test_training_forward_rounds_the_pre_activation(rng):
    """bf16: the split rounds x.W1 + b1 to bf16 before gelu, which the
    no-grad kernel path does not -- both as in the JAX package."""
    arrays = [torch.from_numpy(a).bfloat16() for a in _rand(rng, 16, 16, 64)]
    with torch.no_grad():
        no_grad = fused_ffn(*arrays)
    arrays[0].requires_grad_(True)
    with_grad = fused_ffn(*arrays).detach()
    pre = (arrays[0].detach().float() @ arrays[1].float() + arrays[2].float())
    h = torch.nn.functional.gelu(pre.bfloat16().float()).bfloat16()
    want = (h.float() @ arrays[3].float() + arrays[4].float()).bfloat16()
    assert float((with_grad.float() - want.float()).abs().max()) <= 0.0625
    assert torch.equal(no_grad, fused_ffn_plain(*[a.detach() for a in arrays]))
