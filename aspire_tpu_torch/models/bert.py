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

This slice of the port is the deterministic (eval) pass.  A module in
``train()`` mode with dropout p > 0 raises: the dropout kernels and the
attention backward come with the training slice.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.types import require_device
from ..ops.attention_kernel import fused_attention, fused_attention_plain
from ..ops.ffn_kernel import fused_ffn


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
        'fused' (the kernel with in-kernel dropout, which the training slice
        brings).  'auto' on the CPU -> 'naive'.
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
    ops/ffn_kernel.fused_ffn (intermediate kept on chip); 'fused' forces the
    same wrapper on the CPU too (its plain version); 'naive' forces the
    linear-gelu-linear composition everywhere."""
    if ffn_impl not in ("auto", "fused", "naive"):
        raise ValueError(f"unknown ffn_impl {ffn_impl!r}")
    if ffn_impl == "fused":
        return "fused"
    if ffn_impl == "auto" and on_cuda:
        return "fused"
    return "naive"


class _CastCache:
    """Compute-dtype copies of float32 parameters, cast once and reused.

    The modules keep float32 parameters; an inference pass in bfloat16 would
    otherwise cast every weight at every call.  An entry is refreshed when its
    parameter was modified in place (optimizer step, load_state_dict), moved,
    or asked for in another dtype.
    """

    def __init__(self):
        self._store = {}

    def get(self, key: str, param: torch.Tensor, dtype: torch.dtype,
            transpose: bool = False) -> torch.Tensor:
        if param.dtype == dtype and not transpose:
            return param
        tag = (param.data_ptr(), param._version, param.device, dtype)
        hit = self._store.get(key)
        if hit is not None and hit[0] == tag:
            return hit[1]
        with torch.no_grad():
            src = param.detach().t() if transpose else param.detach()
            value = src.to(dtype).contiguous()
        self._store[key] = (tag, value)
        return value


def _check_cast_grad(params) -> None:
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        raise NotImplementedError(
            "running the encoder in a reduced dtype with gradients enabled "
            "belongs to the training slice of the port; wrap inference in "
            "torch.inference_mode()")


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
        if self.dtype != torch.float32:
            _check_cast_grad((lin.weight, lin.bias))
        w = self._cache.get(name + ".w", lin.weight, self.dtype)
        b = self._cache.get(name + ".b", lin.bias, self.dtype)
        return F.linear(x.to(self.dtype), w, b)


class BertEmbeddings(_Base):
    def __init__(self, config: BertConfig, dtype=torch.float32, device="cuda"):
        super().__init__(dtype)
        cfg = self.config = config
        kw = dict(device=require_device(device), dtype=torch.float32)
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, **kw)
        self.token_type_embeddings = nn.Embedding(
            cfg.type_vocab_size, cfg.hidden_size, **kw)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)

    def forward(self, input_ids, token_type_ids):
        cfg = self.config
        seq_len = input_ids.shape[1]
        if seq_len > cfg.max_position_embeddings:
            raise ValueError(
                f"seq_len {seq_len} exceeds max_position_embeddings "
                f"{cfg.max_position_embeddings}")
        pos_ids = torch.arange(seq_len, device=input_ids.device)[None, :]
        # each embedding is rounded to the compute dtype before the sum
        word = self.word_embeddings(input_ids).to(self.dtype)
        pos = self.position_embeddings(pos_ids).to(self.dtype)
        typ = self.token_type_embeddings(token_type_ids).to(self.dtype)
        return _layer_norm(word + pos + typ, self.LayerNorm, self.dtype)


class BertSelfAttention(_Base):
    """Self-attention with two backends: 'naive' (materialised [b, h, t, t]
    scores) and 'fused_det' (the CUDA kernel: scores, softmax and context on
    chip); see `_select_impl`."""

    def __init__(self, config: BertConfig, dtype=torch.float32,
                 attention_impl: str = "auto", device="cuda"):
        super().__init__(dtype)
        self.config = config
        self.attention_impl = attention_impl
        h = config.hidden_size
        kw = dict(device=require_device(device), dtype=torch.float32)
        self.query = nn.Linear(h, h, **kw)
        self.key = nn.Linear(h, h, **kw)
        self.value = nn.Linear(h, h, **kw)

    def forward(self, x, attn_bias):
        """x: [b, t, h]; attn_bias: f32[b, t] additive key mask."""
        cfg = self.config
        nh = cfg.num_attention_heads
        hd = cfg.hidden_size // nh
        b, t, _ = x.shape
        impl = _select_impl(self.attention_impl, not self.training,
                            cfg.attention_probs_dropout_prob,
                            on_cuda=x.is_cuda)
        if impl == "fused":
            raise NotImplementedError(
                "attention with dropout belongs to the training slice of the "
                "port; call .eval() for the deterministic pass")
        # [b, t, nh, hd] -> [b, nh, t, hd] as views, no copies
        q, k, v = (self._dense(n, x).view(b, t, nh, hd).permute(0, 2, 1, 3)
                   for n in ("query", "key", "value"))
        sm_scale = 1.0 / math.sqrt(hd)
        if impl == "fused_det":
            ctx = fused_attention(q, k, v, attn_bias, sm_scale)
        else:
            ctx = fused_attention_plain(q, k, v, attn_bias, sm_scale)
        return ctx.permute(0, 2, 1, 3).reshape(b, t, cfg.hidden_size)


class BertLayer(_Base):
    def __init__(self, config: BertConfig, dtype=torch.float32,
                 attention_impl: str = "auto", ffn_impl: str = "auto",
                 device="cuda"):
        super().__init__(dtype)
        cfg = self.config = config
        self.ffn_impl = ffn_impl
        dev = require_device(device)
        kw = dict(device=dev, dtype=torch.float32)
        self.attention_self = BertSelfAttention(cfg, dtype, attention_impl, dev)
        self.attention_output_dense = nn.Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        self.attention_output_LayerNorm = nn.LayerNorm(
            cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)
        self.output_LayerNorm = nn.LayerNorm(
            cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)

    def _ffn_fused(self, x):
        i, o = self.intermediate_dense, self.output_dense
        if self.dtype != torch.float32:
            _check_cast_grad((i.weight, i.bias, o.weight, o.bias))
        # the kernel takes [in, out] weights in the compute dtype
        get = self._cache.get
        return fused_ffn(
            x,
            get("ffn.w1", i.weight, self.dtype, transpose=True),
            get("ffn.b1", i.bias, self.dtype),
            get("ffn.w2", o.weight, self.dtype, transpose=True),
            get("ffn.b2", o.bias, self.dtype))

    def forward(self, x, attn_bias):
        attn_out = self.attention_self(x, attn_bias)
        attn_out = self._dense("attention_output_dense", attn_out)
        x = _layer_norm(x + attn_out, self.attention_output_LayerNorm, self.dtype)
        if _select_ffn(self.ffn_impl, on_cuda=x.is_cuda) == "fused":
            out = self._ffn_fused(x)
        else:
            inter = F.gelu(self._dense("intermediate_dense", x),
                           approximate="none")
            out = self._dense("output_dense", inter)
        return _layer_norm(x + out, self.output_LayerNorm, self.dtype)


class BertModel(nn.Module):
    """BERT encoder returning all hidden states (embeddings + each layer).

    forward(input_ids, attention_mask, token_type_ids=None)
      -> (last_hidden_state f32[b, t, h],
          hidden_states: tuple of layer_count+1 f32 tensors).
    """

    def __init__(self, config: BertConfig, dtype=torch.float32,
                 attention_impl: str = "auto", ffn_impl: str = "auto",
                 device="cuda"):
        super().__init__()
        dev = require_device(device)
        self.config = config
        self.dtype = dtype
        self.embeddings = BertEmbeddings(config, dtype, dev)
        for i in range(config.num_hidden_layers):
            self.add_module(f"layer_{i}", BertLayer(
                config, dtype, attention_impl, ffn_impl, dev))

    def forward(self, input_ids, attention_mask, token_type_ids=None):
        cfg = self.config
        if self.training and (cfg.hidden_dropout_prob > 0
                              or cfg.attention_probs_dropout_prob > 0):
            raise NotImplementedError(
                "the training pass (dropout kernels, attention backward) "
                "belongs to the training slice of the port; call .eval() for "
                "the deterministic pass")
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids)
        attn_bias = torch.where(attention_mask > 0, 0.0, -1e9).float()
        hidden_states = [x.float()]
        for i in range(cfg.num_hidden_layers):
            x = getattr(self, f"layer_{i}")(x, attn_bias)
            hidden_states.append(x.float())
        return hidden_states[-1], tuple(hidden_states)


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
