"""Port parity: the initial weights of `models/doc_models.build_model` (Flax's
defaults, `models/init.py`) against the JAX package's `init_params`.

The two packages draw from different generators, so each parameter is held
in distribution: its mean and standard deviation against those of the JAX
parameter of the same name (names matched through models/convert.py).  The
bound is sampling error: 5 / sqrt(n) relative on the spread, 5 sigma /
sqrt(n) on the mean, n the parameter's size and sigma the JAX parameter's
spread (a constant parameter -- LayerNorm scales and offsets, zero biases,
the scalar mix -- must then be equal exactly).  Also: biases are 0, no dense
weight lies beyond its 2 sigma truncation, the same seed gives the same
weights twice and another seed others, and the layers.py heads are drawn as
their Flax counterparts.  BertConfig.tiny(), on the CPU.
"""
import math

import jax
import numpy as np
import pytest
import torch

from aspire_tpu.core.config import ModelHParams as JHP
from aspire_tpu.models import bert as jb
from aspire_tpu.models import doc_models as jdm
from aspire_tpu.models import layers as jl
from aspire_tpu_torch.core.config import ModelHParams as THP
from aspire_tpu_torch.models import bert as tb
from aspire_tpu_torch.models import doc_models as tdm
from aspire_tpu_torch.models import layers as tl
from aspire_tpu_torch.models.convert import (model_state_dict_from_flax_params,
                                             state_dict_from_flax_params)
from aspire_tpu_torch.models.init import TRUNCATED_STD, init_like_flax

MODELS = ["cospecter", "miswordbienc", "miswordabsbienc", "miswordpolyenc",
          "sbalisentbienc", "cosentbert", "ictsentbert"]


def _port(name, seed=0):
    return tdm.build_model(THP(model_name=name), tb.BertConfig.tiny(),
                           device="cpu", seed=seed)


def _hold_in_distribution(got: dict, want: dict) -> int:
    """Each tensor of `got` against the same name in `want`; returns how many
    were random (not constant)."""
    assert set(got) == set(want)
    random = 0
    for name, w in want.items():
        w = torch.as_tensor(np.asarray(w)).double()
        g = got[name].detach().double()
        assert g.shape == w.shape, name
        n = w.numel()
        sw, sg = float(w.std(unbiased=False)), float(g.std(unbiased=False))
        if sw == 0.0:
            assert torch.equal(g, w), f"{name}: constant {float(w.flatten()[0])}"
            continue
        random += 1
        assert abs(sg - sw) <= 5.0 / math.sqrt(n) * sw, \
            f"{name}: spread {sg} against {sw} (n={n})"
        assert abs(float(g.mean()) - float(w.mean())) <= 5.0 * sw / math.sqrt(n), \
            f"{name}: mean {float(g.mean())} against {float(w.mean())}"
    return random


@pytest.mark.parametrize("name", MODELS)
def test_build_model_draws_init_params_distributions(name):
    jmodel = jdm.build_model(JHP(model_name=name), jb.BertConfig.tiny())
    params = jax.tree.map(np.asarray,
                          jmodel.init_params(jax.random.key(0), seq_len=16))
    want = model_state_dict_from_flax_params(params, name)
    model = _port(name)
    assert _hold_in_distribution(model.state_dict(), want) > 0
    for mod_name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Linear):
            if mod.bias is not None:
                assert not bool(mod.bias.any()), mod_name
            cut = 2.0 * math.sqrt(1.0 / mod.in_features) / TRUNCATED_STD
            assert float(mod.weight.detach().abs().max()) <= cut * (1 + 1e-6), mod_name


@pytest.mark.parametrize("name", ["sbalisentbienc", "ictsentbert"])
def test_the_seed_fixes_the_weights(name):
    a, b, c = (_port(name, seed).state_dict() for seed in (3, 3, 4))
    assert all(torch.equal(a[k], b[k]) for k in a)
    tables = [k for k in a if k.endswith("word_embeddings.weight")]
    assert tables and not any(torch.equal(a[k], c[k]) for k in tables)


@pytest.mark.parametrize("head", ["ffn", "ffn_composed", "gated"])
def test_layers_heads_are_drawn_as_flax_draws_them(head):
    d_in = 96
    x = np.zeros((2, 5, d_in), np.float32)
    if head == "gated":
        jmod, tmod = jl.GatedAttention(64), tl.GatedAttention(d_in, 64, device="cpu")
        args = (x, np.full((2,), 5, np.int32))
    else:
        dims = (80,) if head == "ffn_composed" else ()
        jmod = jl.FeedForwardNet(48, composition_dims=dims)
        tmod = tl.FeedForwardNet(d_in, 48, composition_dims=dims, device="cpu")
        args = (x,)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.key(1), *args)["params"])
    init_like_flax(tmod, torch.Generator().manual_seed(0))
    assert _hold_in_distribution(tmod.state_dict(),
                                 state_dict_from_flax_params(params)) > 0
