"""The CUDA FFN's two launches written out in plain PyTorch, against the JAX
package's Pallas FFN kernel in interpret mode: widths zero-padded to
multiples of 64 as the wrapper pads them (`pad_ffn`), weights in the
kernel's [out, in] layout, launch 1 = bias + exact gelu in f32 rounded to
x's dtype (the scratch activation), launch 2 = bias in f32 rounded to x's
dtype, then the padding sliced off.

f32 atol 1e-4: the Pallas kernel's erf is the A&S 7.1.26 polynomial (1.5e-7)
where the port uses the exact erf, plus summation order.  bf16 atol 2e-2: the
activation and the output are each rounded to bf16 on both sides (ulp 2^-7
at O(1)), in the same places.

And a tiny-width model (BertConfig.tiny(): hidden 32, intermediate 64, so
padded) that encodes through ffn_impl="fused" on the CPU against the JAX
model on the same weights (f32, 1e-4).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from aspire_tpu.core.config import ModelHParams as JHP
from aspire_tpu.models import bert as jb
from aspire_tpu.models import doc_models as jdm
from aspire_tpu.ops.pallas_ffn import fused_ffn as j_fused_ffn
from aspire_tpu_torch.core.config import ModelHParams as THP
from aspire_tpu_torch.models import bert as tb
from aspire_tpu_torch.models import doc_models as tdm
from aspire_tpu_torch.models.convert import model_state_dict_from_flax_params
from aspire_tpu_torch.ops.ffn_kernel import (fused_ffn, fused_ffn_linear,
                                             pad_ffn, padded_widths)

from test_torch_doc_models import MS, NO_DROP, T, feats, to_torch


def _rand(rng, rows, h, f):
    mk = lambda *s: (rng.normal(size=s) * 0.1).astype(np.float32)
    return (rng.normal(size=(rows, h)).astype(np.float32),
            mk(h, f), mk(f), mk(f, h), mk(h))


def two_launches(x, w1, b1, w2, b2):
    """x [rows, h]; w1 [f, h], w2 [h, f] ([out, in]); what the kernel's two
    launches compute, padding included."""
    h = x.shape[1]
    x, w1, b1, w2, b2 = pad_ffn(x, w1, b1, w2, b2)
    assert x.shape[1] % 64 == 0 and w1.shape[0] % 64 == 0
    act = F.gelu(x.float() @ w1.float().t() + b1.float(),
                 approximate="none").to(x.dtype)                    # launch 1
    out = (act.float() @ w2.float().t() + b2.float()).to(x.dtype)  # launch 2
    return out[:, :h]


@pytest.mark.parametrize("rows,h,f,dtype,atol", [
    (40, 64, 256, "float32", 1e-4),
    (37, 32, 64, "float32", 1e-4),          # hidden padded 32 -> 64
    (40, 64, 256, "bfloat16", 2e-2),
    (37, 32, 64, "bfloat16", 2e-2),
    (29, 48, 160, "bfloat16", 2e-2),        # ragged: both widths padded, odd rows
])
def test_two_launch_decomposition_matches_pallas_interpret(rng, rows, h, f, dtype, atol):
    arrs = _rand(rng, rows, h, f)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    x, w1, b1, w2, b2 = (torch.from_numpy(a).to(tdt) for a in arrs)
    got = two_launches(x, w1.t().contiguous(), b1, w2.t().contiguous(), b2)
    assert got.dtype == tdt and got.shape == (rows, h)
    want = j_fused_ffn(*(jnp.asarray(a, jdt) for a in arrs), interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol)
    # the wrapper's plain route is the same function
    np.testing.assert_array_equal(
        fused_ffn(x, w1, b1, w2, b2).float().numpy(), got.float().numpy())


def test_padding_is_exact_and_widths_round_up(rng):
    assert padded_widths(768, 3072) == (768, 3072)
    assert padded_widths(32, 64) == (64, 64)
    assert padded_widths(48, 160) == (64, 192)
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _rand(rng, 9, 48, 160))
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    px, pw1, pb1, pw2, pb2 = pad_ffn(x, w1t, b1, w2t, b2)
    assert px.shape == (9, 64) and pw1.shape == (192, 64) and pw2.shape == (64, 192)
    assert float(px[:, 48:].abs().max()) == 0.0 and float(pw1[160:].abs().max()) == 0.0
    full = fused_ffn_linear(px, pw1, pb1, pw2, pb2)
    assert float(full[:, 48:].abs().max()) == 0.0
    np.testing.assert_allclose(full[:, :48].numpy(),
                               fused_ffn(x, w1, b1, w2, b2).numpy(), atol=1e-6)
    assert pad_ffn(px, pw1, pb1, pw2, pb2)[1] is pw1      # nothing to pad


def test_linear_layout_entry_matches_and_is_differentiable(rng):
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _rand(rng, 12, 32, 64))
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    np.testing.assert_array_equal(fused_ffn_linear(x, w1t, b1, w2t, b2).numpy(),
                                  fused_ffn(x, w1, b1, w2, b2).numpy())
    leaf = w1t.clone().requires_grad_(True)
    fused_ffn_linear(x, leaf, b1, w2t, b2).sum().backward()
    ref = w1.clone().requires_grad_(True)
    fused_ffn(x, ref, b1, w2, b2).sum().backward()
    np.testing.assert_allclose(leaf.grad.numpy(), ref.grad.numpy().T, atol=1e-6)
    with pytest.raises(ValueError, match="FFN"):
        fused_ffn_linear(x, w1, b1, w2t, b2)              # [in, out] where [out, in] is due


def test_tiny_model_encodes_through_the_fused_ffn_like_jax(rng):
    hp = dict(model_name="sbalisentbienc", score_aggregation="l2max", max_sents=MS)
    jmodel = jdm.build_model(JHP(**hp), jb.BertConfig.tiny(**NO_DROP))
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        jmodel.init_params(jax.random.key(0), seq_len=T))
    tmodel = tdm.build_model(THP(**hp, ffn_impl="fused"),
                             tb.BertConfig.tiny(**NO_DROP), device="cpu")
    tmodel.load_state_dict(model_state_dict_from_flax_params(params, hp["model_name"]))
    tmodel.eval()
    batch = feats(rng, (3,))
    with torch.no_grad():
        cls, sents = tmodel.encode(to_torch(batch))
    j_cls, j_sents = jmodel.encode(params, jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(cls.numpy(), np.asarray(j_cls), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sents.embed.numpy(), np.asarray(j_sents.embed),
                               rtol=1e-4, atol=1e-4)
