"""Document encoders: contextual-sentence multi-vector and CLS bi-encoder
(counterpart of aspire_tpu/models/encoders.py).

  * `sentence_pool` turns the reference's per-sentence mask loop
    (disent_models.py:513-534) into one one-hot segment-mean product.
    Token->sentence assignment arrives as a compact `sent_ids` tensor.
  * `ConSentEncoder` == AspireConSent (examples/ex_aspire_consent.py:25-101):
    BERT forward, CLS doc rep + per-sentence mean-pooled reps.
  * `BiEncoder` == MySPECTER / AspireBiEnc (disent_models.py:24-205):
    softmax scalar-mix over the 13 hidden-state layers, CLS rep.

`train()` / `eval()` take the place of the Flax `deterministic` flag, and a
training pass gets its dropout seed through `forward(..., seed=...)`.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..core.types import require_device
from ..ops.pool_kernel import sentence_pool_fused, sentence_pool_plain
from .bert import BertConfig, BertModel


def sentence_pool(hidden: torch.Tensor, sent_ids: torch.Tensor,
                  max_sents: int, impl: str = "auto") -> torch.Tensor:
    """Mean-pool contextual token embeddings into per-sentence vectors.

    hidden:   [b, t, h] -- final BERT hidden states.
    sent_ids: int[b, t] -- sentence index per token; -1 for tokens outside
              abstract sentences (CLS/SEP/title/pad).
    Returns f32[b, max_sents, h]; sentences with no tokens give zero vectors
    (the reference divides by clamp(count, 1) -- same result).

    impl: 'auto' sends a CUDA tensor that wants no gradient (grad disabled,
    or `hidden` does not require it) through the CUDA kernel of
    ops/pool_kernel.py, which has no backward, and everything else -- a pass
    under grad, a CPU tensor -- through the plain one-hot product; 'fused'
    asks for the kernel's wrapper on either device (its plain version on the
    CPU) and raises under grad; 'naive' is the plain product everywhere.
    """
    if impl not in ("auto", "fused", "naive"):
        raise ValueError(f"unknown pool_impl {impl!r}")
    wants_grad = torch.is_grad_enabled() and hidden.requires_grad
    if impl == "fused" and wants_grad:
        raise ValueError("pool_impl='fused' has no backward: run it under "
                         "torch.no_grad() or pass 'auto'")
    if impl == "fused" or (impl == "auto" and hidden.is_cuda
                           and not wants_grad):
        return sentence_pool_fused(hidden, sent_ids, max_sents)
    return sentence_pool_plain(hidden, sent_ids, max_sents)


def span_pool(hidden: torch.Tensor, span_mask: torch.Tensor) -> torch.Tensor:
    """Mean-pool token embeddings over arbitrary (possibly overlapping) spans.

    hidden: [b, t, h]; span_mask: [b, e, t] (1.0 at member tokens).
    Returns f32[b, e, h]; all-zero spans give zero vectors
    (AspireConSenContextual._get_ner_reps, utils/models.py:465-477)."""
    m = span_mask.float()
    sums = torch.matmul(m, hidden.float())
    counts = torch.clamp_min(m.sum(dim=2), 1.0)
    return sums / counts[:, :, None]


class ConSentEncoder(nn.Module):
    """Contextual sentence multi-vector encoder (AspireConSent).

    forward(token_ids, attn_mask, sent_ids, token_type_ids=None, seed=None)
      -> (doc_cls f32[b, h], sent_reps f32[b, max_sents, h])
    """

    def __init__(self, config: BertConfig, max_sents: int = 24,
                 dtype=torch.float32, attention_impl: str = "auto",
                 ffn_impl: str = "auto", device="cuda",
                 hidden_dropout_impl: str = "auto", pool_impl: str = "auto"):
        super().__init__()
        self.config = config
        self.max_sents = max_sents
        self.pool_impl = pool_impl
        self.bert = BertModel(config, dtype, attention_impl, ffn_impl,
                              require_device(device), hidden_dropout_impl)

    def forward(self, token_ids, attn_mask, sent_ids, token_type_ids=None,
                seed=None):
        last, _ = self.bert(token_ids, attn_mask, token_type_ids, seed)
        return last[:, 0, :], sentence_pool(last, sent_ids, self.max_sents,
                                            self.pool_impl)


class ConSentSpanEncoder(ConSentEncoder):
    """ConSentEncoder + per-entity token-span reps in sentence context
    (AspireConSenContextual, utils/models.py:413-507).  Same parameters as
    ConSentEncoder, so any aspire checkpoint loads unchanged.

    forward(token_ids, attn_mask, sent_ids, span_mask)
      -> (doc_cls f32[b,h], sent_reps f32[b,max_sents,h], ent_reps f32[b,e,h])
    """

    def forward(self, token_ids, attn_mask, sent_ids, span_mask,
                token_type_ids=None, seed=None):
        last, _ = self.bert(token_ids, attn_mask, token_type_ids, seed)
        return (last[:, 0, :],
                sentence_pool(last, sent_ids, self.max_sents, self.pool_impl),
                span_pool(last, span_mask))


class BiEncoder(nn.Module):
    """CLS bi-encoder with softmax scalar-mix over layers (MySPECTER).

    The mix weights mirror SoftmaxMixLayers (generic_layers.py:71-80): a
    learned [layer_count] vector, softmaxed, weighting the per-layer CLS reps.
    """

    def __init__(self, config: BertConfig, dtype=torch.float32,
                 attention_impl: str = "auto", ffn_impl: str = "auto",
                 device="cuda", hidden_dropout_impl: str = "auto"):
        super().__init__()
        dev = require_device(device)
        self.config = config
        self.bert = BertModel(config, dtype, attention_impl, ffn_impl, dev,
                              hidden_dropout_impl)
        self.layer_weights = nn.Parameter(torch.zeros(
            config.num_hidden_layers + 1, dtype=torch.float32, device=dev))

    def forward(self, token_ids, attn_mask, token_type_ids=None, seed=None):
        _, hidden_states = self.bert(token_ids, attn_mask, token_type_ids, seed)
        mix = torch.softmax(self.layer_weights, dim=0)
        cls_stack = torch.stack([h[:, 0, :] for h in hidden_states], dim=-1)
        return torch.matmul(cls_stack, mix)


def bienc_layer_weights_from_state_dict(state_dict) -> torch.Tensor:
    """Extract SoftmaxMixLayers weights ([1, 13]) -> the [13] parameter."""
    for key in ("bert_layer_weights.weight", "bert_layer_weights"):
        if key in state_dict:
            return torch.as_tensor(state_dict[key]).detach().float().reshape(-1).cpu()
    raise KeyError("bert_layer_weights not found in state dict")
