"""MPNet encoder (the `sbmpnet1B` baseline, all-mpnet-base-v2), read from a
local Hugging Face directory without `transformers`.

Module and parameter names are Hugging Face's ``MPNetModel`` names
(``embeddings.word_embeddings``, ``encoder.layer.3.attention.attn.q``,
``encoder.relative_attention_bias``), so a checkpoint's state_dict loads as it
is (models/convert.py strips an ``mpnet.`` prefix and the pooler).

The encoder is BERT's post-LayerNorm stack with two differences: no token
type embeddings, and a relative position bias -- one shared
``Embedding(relative_attention_num_buckets, heads)`` looked up by HF's
`relative_position_bucket` and added to every layer's scores.

* The FFN, gelu(x.W1 + b1).W2 + b2, is the same function as BERT's and goes
  through ops/ffn_kernel.fused_ffn_linear (K3) on the card.
* The attention is this module's own PyTorch code: scores, plus the per-head
  [h, t, t] position bias and the key mask, softmax, times v.  It is not K2
  and does not call K2's plain version: K2 takes a [b, t] key bias only
  (ops/attention_kernel.py), the TPU kernel takes no per-head bias either,
  and the JAX package runs MPNet outside its Pallas kernels too.  So this is
  MPNet's attention on every device, not a fallback.

Inference only: the module computes the deterministic pass (the baselines
are evaluated, never trained here); a forward in train() mode raises.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.types import require_device
from ..ops.ffn_kernel import fused_ffn_linear
from .bert import _select_ffn, position_ids_past_padding

# HF's MPNetEmbeddings fixes the padding id of its position ids at 1,
# whatever the config says
PADDING_IDX = 1


@dataclasses.dataclass(frozen=True)
class MPNetConfig:
    vocab_size: int = 30527          # all-mpnet-base-v2
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    layer_norm_eps: float = 1e-5
    relative_attention_num_buckets: int = 32

    @classmethod
    def from_hf(cls, raw: dict) -> "MPNetConfig":
        """From config.json's dict (HF's MPNetConfig defaults where a key is
        missing)."""
        if raw.get("hidden_act", "gelu") != "gelu":
            raise ValueError(f"hidden_act {raw['hidden_act']!r}: the port's "
                             "MPNet runs the exact gelu only")
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in names})


def relative_position_bucket(relative_position: torch.Tensor,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """HF's MPNet bucketing (T5's, bidirectional): half the buckets a sign,
    exact below num_buckets / 4, logarithmic up to max_distance, the last
    bucket beyond.  relative_position = key position - query position."""
    n = -relative_position
    num_buckets //= 2
    ret = (n < 0).long() * num_buckets
    n = torch.abs(n)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    # clamp so that log(0) never appears (those entries take the exact branch)
    large = max_exact + (
        torch.log(n.clamp_min(1).float() / max_exact)
        / math.log(max_distance / max_exact) * (num_buckets - max_exact)).long()
    large = torch.clamp_max(large, num_buckets - 1)
    return ret + torch.where(is_small, n, large)


class MPNetEmbeddings(nn.Module):
    def __init__(self, config: MPNetConfig, device):
        super().__init__()
        kw = dict(device=device, dtype=torch.float32)
        self.word_embeddings = nn.Embedding(config.vocab_size,
                                            config.hidden_size, **kw)
        self.position_embeddings = nn.Embedding(config.max_position_embeddings,
                                                config.hidden_size, **kw)
        self.LayerNorm = nn.LayerNorm(config.hidden_size,
                                      eps=config.layer_norm_eps, **kw)


class MPNetSelfAttention(nn.Module):
    def __init__(self, config: MPNetConfig, device):
        super().__init__()
        h = config.hidden_size
        kw = dict(device=device, dtype=torch.float32)
        self.q, self.k, self.v, self.o = (nn.Linear(h, h, **kw)
                                          for _ in range(4))


class MPNetAttention(nn.Module):
    def __init__(self, config: MPNetConfig, device):
        super().__init__()
        self.attn = MPNetSelfAttention(config, device)
        self.LayerNorm = nn.LayerNorm(config.hidden_size,
                                      eps=config.layer_norm_eps, device=device)


class _Dense(nn.Module):
    def __init__(self, n_in: int, n_out: int, device, eps: float | None = None):
        super().__init__()
        self.dense = nn.Linear(n_in, n_out, device=device)
        if eps is not None:
            self.LayerNorm = nn.LayerNorm(n_out, eps=eps, device=device)


class MPNetLayer(nn.Module):
    def __init__(self, config: MPNetConfig, device, ffn_impl: str):
        super().__init__()
        self.config = config
        self.ffn_impl = ffn_impl
        self.attention = MPNetAttention(config, device)
        self.intermediate = _Dense(config.hidden_size, config.intermediate_size,
                                   device)
        self.output = _Dense(config.intermediate_size, config.hidden_size,
                             device, config.layer_norm_eps)

    def _attend(self, x, bias):
        """Scaled q.k^T + bias ([b or 1, h, t, t]: position bias and key
        mask), softmax, times v, then the output projection."""
        cfg, a = self.config, self.attention.attn
        b, t, _ = x.shape
        nh = cfg.num_attention_heads
        hd = cfg.hidden_size // nh
        q, k, v = (lin(x).view(b, t, nh, hd).transpose(1, 2)
                   for lin in (a.q, a.k, a.v))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd) + bias
        ctx = torch.matmul(torch.softmax(scores, dim=-1), v)
        return a.o(ctx.transpose(1, 2).reshape(b, t, cfg.hidden_size))

    def forward(self, x, bias):
        ln = self.attention.LayerNorm
        x = ln(self._attend(x, bias) + x)
        i, o = self.intermediate.dense, self.output.dense
        if _select_ffn(self.ffn_impl, on_cuda=x.is_cuda) == "fused":
            out = fused_ffn_linear(x, i.weight, i.bias, o.weight, o.bias)
        else:
            out = o(F.gelu(i(x), approximate="none"))
        return self.output.LayerNorm(out + x)


class MPNetEncoder(nn.Module):
    def __init__(self, config: MPNetConfig, device, ffn_impl: str):
        super().__init__()
        self.layer = nn.ModuleList(MPNetLayer(config, device, ffn_impl)
                                   for _ in range(config.num_hidden_layers))
        self.relative_attention_bias = nn.Embedding(
            config.relative_attention_num_buckets, config.num_attention_heads,
            device=device)


class MPNetModel(nn.Module):
    """MPNet encoder in float32 returning all hidden states.

    forward(input_ids, attention_mask)
      -> (last_hidden_state f32[b, t, h], hidden_states: tuple of
          layer_count + 1 f32 tensors), as BertModel returns them.
    ffn_impl: as BertLayer's ('auto': K3 on CUDA tensors).
    """

    def __init__(self, config: MPNetConfig, ffn_impl: str = "auto",
                 device="cuda"):
        super().__init__()
        dev = require_device(device)
        self.config = config
        self.embeddings = MPNetEmbeddings(config, dev)
        self.encoder = MPNetEncoder(config, dev, ffn_impl)

    def position_bias(self, t: int, device) -> torch.Tensor:
        """f32[1, heads, t, t]: the relative position bias of every layer."""
        pos = torch.arange(t, device=device)
        bucket = relative_position_bucket(
            pos[None, :] - pos[:, None],
            self.config.relative_attention_num_buckets)
        return self.encoder.relative_attention_bias(bucket).permute(2, 0, 1)[None]

    def forward(self, input_ids, attention_mask):
        if self.training:
            raise ValueError("MPNetModel computes the deterministic pass only: "
                             "call .eval() first")
        cfg, emb = self.config, self.embeddings
        pos = position_ids_past_padding(input_ids, PADDING_IDX,
                                        cfg.max_position_embeddings)
        x = emb.LayerNorm(emb.word_embeddings(input_ids)
                          + emb.position_embeddings(pos.long()))
        key_bias = torch.where(attention_mask > 0, 0.0, -1e9).float()
        bias = self.position_bias(input_ids.shape[1], x.device) \
            + key_bias[:, None, None, :]
        hidden_states = [x]
        for layer in self.encoder.layer:
            x = layer(x, bias)
            hidden_states.append(x)
        return x, tuple(hidden_states)
