"""BERT encoder as PyTorch modules (counterpart of aspire_tpu/models/bert.py).

  * parameters stay float32; the ``dtype`` knob runs activations and the
    dense products in bfloat16 while LayerNorms run in float32 and are cast
    back -- the rounding points of the Flax model (each dense output and each
    of the three embeddings rounded to ``dtype``);
  * returns the full tuple of hidden states (embeddings + every layer) so the
    scalar-mix bi-encoder can weight across layers;
  * the attention mask is additive (-1e9 at pads), folded pre-softmax;
  * module and parameter names follow the Flax tree
    (``layer_3.attention_self.query.weight``), so carrying weights across is
    a rename plus a transpose (models/convert.py).

A module in ``eval()`` mode runs the deterministic pass.  In ``train()`` mode
it applies hidden dropout at 25 sites an encode (site 0 on the float32
embedding LayerNorm output before the cast, sites 1 + 2i and 2 + 2i in layer
i on the compute dtype before each residual add) and attention-probability
dropout (site = layer index), all keyed on one 64-bit ``seed`` per encode that
the caller passes to ``forward`` (ops/philox.py); a data rank passes a
``philox.Seed`` that also names its first example's place in the whole batch,
so that its masks are those rows of the one-process masks.  Under grad, reduced-dtype
copies of the float32 parameters are made inside the graph, so the parameters
receive float32 gradients.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.types import require_device
from ..ops.attention_kernel import (attention_keep_mask, fused_attention,
                                    fused_attention_plain)
from ..ops.dropout_kernel import dropout_plain, fused_dropout, keep_mask
from ..ops.philox import split_seed
from ..ops.ffn_kernel import fused_ffn_linear


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 31090          # scibert_scivocab_uncased
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1

    @classmethod
    def tiny(cls, **kw) -> "BertConfig":
        """Small config for tests."""
        base = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=64,
                    max_position_embeddings=64)
        base.update(kw)
        return cls(**base)


def _select_impl(attention_impl: str, deterministic: bool, dropout_p: float,
                 on_cuda: bool = True) -> str:
    """Backend-selection policy for BertSelfAttention, keyed on where the
    input tensor lies.

      * 'auto' on CUDA: deterministic (or p=0) passes -> 'fused_det', the
        CUDA kernel of ops/attention_kernel.py; dropout training passes ->
        'fused' (the same kernel with in-kernel dropout).  'auto' on the CPU
        -> 'naive'.
      * 'fused': as 'auto' on CUDA; on the CPU it still sends dropout
        training passes to 'fused' and everything else to 'naive'.
      * 'fused_det': by explicit request on either device (on CPU tensors the
        kernel's wrapper runs its plain version).
      * 'naive': materialised [b, h, t, t] scores everywhere -- the yardstick.
    """
    if attention_impl not in ("auto", "fused", "fused_det", "naive"):
        raise ValueError(f"unknown attention_impl {attention_impl!r}")
    if attention_impl == "fused_det":
        return "fused_det"
    training_dropout = not deterministic and dropout_p > 0
    if attention_impl == "fused":
        if training_dropout:
            return "fused"
        return "fused_det" if on_cuda else "naive"
    if attention_impl == "auto" and on_cuda:
        return "fused" if training_dropout else "fused_det"
    return "naive"


def _select_ffn(ffn_impl: str, on_cuda: bool = True) -> str:
    """FFN backend policy: 'auto' routes CUDA passes through
    ops/ffn_kernel.fused_ffn_linear (the kernel without grad); 'fused' forces the
    same wrapper on the CPU too (its plain version); 'naive' forces the
    linear-gelu-linear composition everywhere."""
    if ffn_impl not in ("auto", "fused", "naive"):
        raise ValueError(f"unknown ffn_impl {ffn_impl!r}")
    if ffn_impl == "fused":
        return "fused"
    if ffn_impl == "auto" and on_cuda:
        return "fused"
    return "naive"


def _select_hidden_dropout(hidden_dropout_impl: str, on_cuda: bool = True) -> str:
    """Hidden-dropout backend policy: 'auto' on CUDA and 'fused' everywhere ->
    ops/dropout_kernel.fused_dropout (mask made in the kernel, nothing
    mask-shaped kept for the backward; on CPU tensors its plain version);
    'naive', and 'auto' on the CPU -> a materialised mask applied with plain
    tensor operations.  Both draw the same Philox bits from the same seed."""
    if hidden_dropout_impl not in ("auto", "fused", "naive"):
        raise ValueError(f"unknown hidden_dropout_impl {hidden_dropout_impl!r}")
    if hidden_dropout_impl == "fused":
        return "fused"
    if hidden_dropout_impl == "auto" and on_cuda:
        return "fused"
    return "naive"


def _hidden_dropout(x, p: float, training: bool, impl: str, seed, site: int):
    """One hidden/embedding dropout site of x [b, ..., h]; identity in eval
    mode or at p = 0.  seed: a 64-bit int or a philox.Seed, whose first
    example's place offsets the Philox rows by that many examples' rows."""
    if not training or p == 0.0:
        return x
    seed, example0 = split_seed(seed)
    if seed is None:
        raise ValueError("a training pass with dropout needs the encode's "
                         "seed: forward(..., seed=<64-bit int>)")
    row0 = example0 * (x[0].numel() // x.shape[-1])
    if _select_hidden_dropout(impl, on_cuda=x.is_cuda) == "fused":
        return fused_dropout(x, p, seed=seed, site=site, row0=row0)
    keep = keep_mask(x.shape, p, seed=seed, site=site, device=x.device,
                     row0=row0)
    return dropout_plain(x, keep, p)


class _CastCache:
    """Compute-dtype copies of float32 parameters, cast once and reused.

    The modules keep float32 parameters; an inference pass in bfloat16 would
    otherwise cast every weight at every call.  An entry is refreshed when its
    parameter was modified in place (optimizer step, load_state_dict), moved,
    or asked for in another dtype.  Used for no-grad passes only: under grad
    the cast has to be part of the graph (`_param`).
    """

    def __init__(self):
        self._store = {}

    def get(self, key: str, param: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if param.dtype == dtype:
            return param
        tag = (param.data_ptr(), param._version, param.device, dtype)
        hit = self._store.get(key)
        if hit is not None and hit[0] == tag:
            return hit[1]
        with torch.no_grad():
            value = param.detach().to(dtype).contiguous()
        self._store[key] = (tag, value)
        return value


def _param(cache: _CastCache, key: str, param: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """The parameter in the compute dtype: a cached detached copy without
    grad, a cast inside the graph with it (float32 parameters then receive
    float32 gradients, as Flax's param_dtype=float32, dtype=bf16 does)."""
    if torch.is_grad_enabled() and param.requires_grad:
        return param.to(dtype)
    return cache.get(key, param, dtype)


def _layer_norm(x, ln: nn.LayerNorm, dtype):
    """LayerNorm in float32, cast back to the compute dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(dtype)


class _Base(nn.Module):
    """Shared plumbing: compute dtype, cast cache, dense-in-dtype."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self._cache = _CastCache()

    def _dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        lin = getattr(self, name)
        w = _param(self._cache, name + ".w", lin.weight, self.dtype)
        b = _param(self._cache, name + ".b", lin.bias, self.dtype)
        return F.linear(x.to(self.dtype), w, b)


class BertEmbeddings(_Base):
    def __init__(self, config: BertConfig, dtype=torch.float32, device="cuda",
                 hidden_dropout_impl: str = "auto"):
        super().__init__(dtype)
        cfg = self.config = config
        self.hidden_dropout_impl = hidden_dropout_impl
        kw = dict(device=require_device(device), dtype=torch.float32)
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, **kw)
        self.token_type_embeddings = nn.Embedding(
            cfg.type_vocab_size, cfg.hidden_size, **kw)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)

    def forward(self, input_ids, token_type_ids, seed=None, position_ids=None):
        """position_ids: int[b, t], or None for BERT's 0..t-1."""
        cfg = self.config
        if position_ids is None:
            check_positions(input_ids.shape[1], cfg.max_position_embeddings)
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)[None, :]
        # each embedding is rounded to the compute dtype before the sum
        word = self.word_embeddings(input_ids).to(self.dtype)
        pos = self.position_embeddings(position_ids).to(self.dtype)
        typ = self.token_type_embeddings(token_type_ids).to(self.dtype)
        ln = self.LayerNorm
        x = F.layer_norm((word + pos + typ).float(), ln.normalized_shape,
                         ln.weight, ln.bias, ln.eps)
        # dropout on the float32 LayerNorm output, then the cast
        x = _hidden_dropout(x, cfg.hidden_dropout_prob, self.training,
                            self.hidden_dropout_impl, seed, site=0)
        return x.to(self.dtype)


class BertSelfAttention(_Base):
    """Self-attention with two backends: 'naive' (materialised [b, h, t, t]
    scores, probabilities and mask) and 'fused' / 'fused_det' (the CUDA
    kernels: scores, softmax, dropout and context on chip, the backward from
    q, k, v alone); see `_select_impl`."""

    def __init__(self, config: BertConfig, dtype=torch.float32,
                 attention_impl: str = "auto", device="cuda",
                 layer_idx: int = 0):
        super().__init__(dtype)
        self.config = config
        self.attention_impl = attention_impl
        self.layer_idx = layer_idx
        h = config.hidden_size
        kw = dict(device=require_device(device), dtype=torch.float32)
        self.query = nn.Linear(h, h, **kw)
        self.key = nn.Linear(h, h, **kw)
        self.value = nn.Linear(h, h, **kw)

    def forward(self, x, attn_bias, seed=None):
        """x: [b, t, h]; attn_bias: f32[b, t] additive key mask; seed: the
        encode's 64-bit seed or a philox.Seed (training passes with
        dropout)."""
        cfg = self.config
        nh = cfg.num_attention_heads
        hd = cfg.hidden_size // nh
        b, t, _ = x.shape
        impl = _select_impl(self.attention_impl, not self.training,
                            cfg.attention_probs_dropout_prob,
                            on_cuda=x.is_cuda)
        p = cfg.attention_probs_dropout_prob if self.training else 0.0
        seed, example0 = split_seed(seed)
        if p > 0.0 and seed is None:
            raise ValueError("a training pass with dropout needs the encode's "
                             "seed: forward(..., seed=<64-bit int>)")
        # [b, t, nh, hd] -> [b, nh, t, hd] as views, no copies
        q, k, v = (self._dense(n, x).view(b, t, nh, hd).permute(0, 2, 1, 3)
                   for n in ("query", "key", "value"))
        sm_scale = 1.0 / math.sqrt(hd)
        if impl == "fused_det":
            ctx = fused_attention(q, k, v, attn_bias, sm_scale)
        elif impl == "fused":
            ctx = fused_attention(q, k, v, attn_bias, sm_scale, p, seed=seed,
                                  site=self.layer_idx, plane0=example0 * nh)
        else:
            keep = None
            if p > 0.0:
                keep = attention_keep_mask(q.shape, p, seed=seed,
                                           site=self.layer_idx, device=x.device,
                                           plane0=example0 * nh)
            ctx = fused_attention_plain(q, k, v, attn_bias, sm_scale, p, keep)
        return ctx.permute(0, 2, 1, 3).reshape(b, t, cfg.hidden_size)


class BertLayer(_Base):
    def __init__(self, config: BertConfig, dtype=torch.float32,
                 attention_impl: str = "auto", ffn_impl: str = "auto",
                 device="cuda", hidden_dropout_impl: str = "auto",
                 layer_idx: int = 0):
        super().__init__(dtype)
        cfg = self.config = config
        self.ffn_impl = ffn_impl
        self.hidden_dropout_impl = hidden_dropout_impl
        self.layer_idx = layer_idx
        dev = require_device(device)
        kw = dict(device=dev, dtype=torch.float32)
        self.attention_self = BertSelfAttention(cfg, dtype, attention_impl, dev,
                                                layer_idx)
        self.attention_output_dense = nn.Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        self.attention_output_LayerNorm = nn.LayerNorm(
            cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)
        self.output_LayerNorm = nn.LayerNorm(
            cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)

    def _ffn_fused(self, x):
        i, o = self.intermediate_dense, self.output_dense
        # the kernel reads nn.Linear's [out, in] weights in the compute dtype:
        # cached contiguous copies without grad, in-graph casts with it
        get = lambda key, param: _param(self._cache, key, param, self.dtype)
        return fused_ffn_linear(
            x, get("ffn.w1", i.weight), get("ffn.b1", i.bias),
            get("ffn.w2", o.weight), get("ffn.b2", o.bias))

    def _dropout(self, x, seed, site: int):
        return _hidden_dropout(x, self.config.hidden_dropout_prob,
                               self.training, self.hidden_dropout_impl, seed,
                               site)

    def forward(self, x, attn_bias, seed=None):
        attn_out = self.attention_self(x, attn_bias, seed)
        attn_out = self._dense("attention_output_dense", attn_out)
        attn_out = self._dropout(attn_out, seed, 1 + 2 * self.layer_idx)
        x = _layer_norm(x + attn_out, self.attention_output_LayerNorm, self.dtype)
        if _select_ffn(self.ffn_impl, on_cuda=x.is_cuda) == "fused":
            out = self._ffn_fused(x)
        else:
            inter = F.gelu(self._dense("intermediate_dense", x),
                           approximate="none")
            out = self._dense("output_dense", inter)
        out = self._dropout(out, seed, 2 + 2 * self.layer_idx)
        return _layer_norm(x + out, self.output_LayerNorm, self.dtype)


class BertModel(nn.Module):
    """BERT encoder returning all hidden states (embeddings + each layer).

    forward(input_ids, attention_mask, token_type_ids=None, seed=None,
            position_ids=None)
      -> (last_hidden_state f32[b, t, h],
          hidden_states: tuple of layer_count+1 f32 tensors).
    `seed` is the encode's 64-bit dropout seed: needed in train() mode when a
    dropout probability is above 0, unused in eval() mode.
    """

    def __init__(self, config: BertConfig, dtype=torch.float32,
                 attention_impl: str = "auto", ffn_impl: str = "auto",
                 device="cuda", hidden_dropout_impl: str = "auto"):
        super().__init__()
        dev = require_device(device)
        self.config = config
        self.dtype = dtype
        self.embeddings = BertEmbeddings(config, dtype, dev, hidden_dropout_impl)
        for i in range(config.num_hidden_layers):
            self.add_module(f"layer_{i}", BertLayer(
                config, dtype, attention_impl, ffn_impl, dev,
                hidden_dropout_impl, layer_idx=i))

    def forward(self, input_ids, attention_mask, token_type_ids=None,
                seed=None, position_ids=None):
        cfg = self.config
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids, seed, position_ids)
        attn_bias = torch.where(attention_mask > 0, 0.0, -1e9).float()
        hidden_states = [x.float()]
        for i in range(cfg.num_hidden_layers):
            x = getattr(self, f"layer_{i}")(x, attn_bias, seed)
            hidden_states.append(x.float())
        return hidden_states[-1], tuple(hidden_states)


def check_positions(last: int, max_position_embeddings: int) -> None:
    """Raise on a position past the table, before a lookup would read out
    of range on the card."""
    if last > max_position_embeddings:
        raise ValueError(f"positions up to {last} exceed "
                         f"max_position_embeddings {max_position_embeddings}")


def position_ids_past_padding(input_ids: torch.Tensor, padding_idx: int,
                              max_position_embeddings: int) -> torch.Tensor:
    """RoBERTa's and MPNet's position ids (HF's
    ``create_position_ids_from_input_ids``): a token's position is
    padding_idx + its count of non-pad tokens so far, a pad's is padding_idx."""
    check_positions(input_ids.shape[1] + padding_idx + 1, max_position_embeddings)
    keep = (input_ids != padding_idx).int()
    return torch.cumsum(keep, dim=1).int() * keep + padding_idx


class RobertaModel(BertModel):
    """RoBERTa: BERT's layers and names (``type_vocab_size`` 1, LayerNorm eps
    1e-5 in its config), with the position ids counted past the padding id.
    The same forward and outputs as BertModel; the encode runs K2 and K3."""

    def __init__(self, config: BertConfig, padding_idx: int = 1, **kw):
        super().__init__(config, **kw)
        self.padding_idx = padding_idx

    def forward(self, input_ids, attention_mask, token_type_ids=None,
                seed=None):
        pos = position_ids_past_padding(input_ids, self.padding_idx,
                                        self.config.max_position_embeddings)
        return super().forward(input_ids, attention_mask, token_type_ids, seed,
                               pos.long())


class BertPooler(_Base):
    """HF BertPooler: tanh(dense(CLS)) -- the `pooler_output` head.

    Kept outside BertModel: the framework's own models score from hidden
    states / CLS directly, and only the SimCSE baselines need it.  Apply to
    `last_hidden_state`."""

    def __init__(self, config: BertConfig, dtype=torch.float32, device="cuda"):
        super().__init__(dtype)
        self.config = config
        self.dense = nn.Linear(config.hidden_size, config.hidden_size,
                               device=require_device(device), dtype=torch.float32)

    def forward(self, last_hidden_state):
        cls = last_hidden_state[:, 0, :]
        return torch.tanh(self._dense("dense", cls).float())
