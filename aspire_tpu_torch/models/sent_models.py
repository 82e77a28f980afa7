"""Sentence-encoder training models (cosentbert / ictsentbert), counterpart
of aspire_tpu/models/sent_models.py
(src/learning/facetid_models/sentsim_models.py:11-126):

  * SentTripleModel (cosentbert): one BERT tower, CLS rep, L2 triplet with
    in-batch shuffled negatives.
  * ICTModel (ictsentbert): two towers (sentence + context), cross-entropy
    over the in-batch dot-product similarity matrix.

Both consume the same feature dicts as the doc models (sent_ids unused).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..core.config import ModelHParams
from ..core.types import require_device
from .bert import BertConfig, BertModel
from .doc_models import _cls_l2_triplet, draw_step_rng


def _tower(hp: ModelHParams, bert_config: BertConfig, dtype, device):
    return BertModel(bert_config, dtype=dtype,
                     attention_impl=hp.attention_impl, ffn_impl=hp.ffn_impl,
                     device=require_device(device),
                     hidden_dropout_impl=hp.hidden_dropout_impl)


def _cls(encoder, feats, seed):
    last, _ = encoder(feats["token_ids"], feats["attn_mask"], seed=seed)
    return last[:, 0, :]


class SentTripleModel(nn.Module):
    """cosentbert: CLS triplet with in-batch negatives (sentsim_models.py:11-78)."""

    def __init__(self, hp: ModelHParams, bert_config: BertConfig,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.hp = hp
        self.bert_config = bert_config
        self.encoder = _tower(hp, bert_config, dtype, device)

    def encode(self, feats, seed: int | None = None):
        return _cls(self.encoder, feats, seed), None

    def train_loss(self, batch, rng: torch.Generator | None = None,
                   train: bool = True) -> torch.Tensor:
        self.train(train)
        has_neg = "neg" in batch
        b = batch["query"]["token_ids"].shape[0]
        seeds, perm = draw_step_rng(rng if (train or not has_neg) else None,
                                    b, not has_neg)
        q = _cls(self.encoder, batch["query"], seeds[0])
        p = _cls(self.encoder, batch["pos"], seeds[1])
        if has_neg:
            n = _cls(self.encoder, batch["neg"], seeds[2])
        else:
            n = p[perm.to(p.device)]
        return _cls_l2_triplet(q, p, n)


class ICTModel(nn.Module):
    """ictsentbert: two-tower in-batch softmax (sentsim_models.py:81-126)."""

    def __init__(self, hp: ModelHParams, bert_config: BertConfig,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.hp = hp
        self.bert_config = bert_config
        self.sent_encoder = _tower(hp, bert_config, dtype, device)
        self.context_encoder = _tower(hp, bert_config, dtype, device)

    def encode(self, feats, seed: int | None = None):
        return _cls(self.sent_encoder, feats, seed), None

    def train_loss(self, batch, rng: torch.Generator | None = None,
                   train: bool = True) -> torch.Tensor:
        self.train(train)
        seeds, _ = draw_step_rng(rng if train else None, 0, False)
        q = _cls(self.sent_encoder, batch["query"], seeds[0])
        p = _cls(self.context_encoder, batch["pos"], seeds[1])
        sims = torch.matmul(q.float(), p.float().t())
        # cross-entropy, reduction='sum', targets = diagonal
        logp = torch.log_softmax(sims, dim=1)
        return -torch.diagonal(logp).sum()
