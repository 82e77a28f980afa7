"""Document-similarity model zoo: encoders + training losses + scoring
(counterpart of aspire_tpu/models/doc_models.py, itself a re-design of
src/learning/facetid_models/disent_models.py).

One class per reference model family, all `nn.Module`s that own their
encoder:

  * `encode(feats, seed=None)`  -- features -> (doc_cls, MultiVec sentence reps)
  * `train_loss(batch, rng, train)` -- triplet losses with in-batch negatives
  * `train_loss_grouped(superbatch, rng, train)` -- the same over a whole
                                  accumulation window with one wide encode
  * `score_reps(q, c)`          -- test-time similarity from cached reps
                                  (reference caching_score, disent_models.py:256-342)

Model registry names match main_fsim.py:91-99:
  cospecter      -> CLS bi-encoder, scalar layer mix, L2 triplet
  miswordbienc   -> contextual sentence reps, pluggable distance triplet
  sbalisentbienc -> + pre-aligned sentence supervision (tsAspire / ts+otAspire)
  miswordpolyenc -> poly-encoder joint-softmax distance

Against the JAX package: `params` is gone from the signatures (the module
holds them), `rng` is a host `torch.Generator` from which a call draws one
64-bit dropout seed per encode and the in-batch-negative permutation, and
`train` sets the module's train()/eval() mode for the call.  Losses mirror the
reference: TripletMarginWithDistanceLoss(margin=1, reduction='sum') over
distances, torch TripletMarginLoss(margin=1, p=2) for CLS reps, in-batch
negatives via permutation of positives (disent_models.py:447-467,802-837).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..core.config import ModelHParams
from ..core.types import MultiVec, require_device
from ..ops.cdist import pairwise_l2
from ..ops.distances import get_dist_function, l2sup_dist, l2sup_weighted_dist
from ..ops.sinkhorn import grouped_max_diameter
from .bert import BertConfig
from .encoders import BiEncoder, ConSentEncoder


# Every loss term is a sum over the batch's examples.  The helpers return the
# per-example terms ([b]) when asked (`per_example=True`), so that the grouped
# loss can take all micro batches in one call and sum each group afterwards.
def _triplet_margin(d_ap, d_an, margin: float = 1.0,
                    per_example: bool = False) -> torch.Tensor:
    """sum(relu(d(a,p) - d(a,n) + margin)) -- torch TripletMarginWithDistanceLoss."""
    terms = torch.clamp_min(d_ap - d_an + margin, 0.0)
    return terms if per_example else terms.sum()


def _cls_l2_triplet(q, p, n, margin: float = 1.0,
                    per_example: bool = False) -> torch.Tensor:
    """torch TripletMarginLoss(margin=1, p=2, reduction='sum') on CLS reps."""
    d_ap = torch.linalg.vector_norm(q - p + 1e-6, dim=-1)
    d_an = torch.linalg.vector_norm(q - n + 1e-6, dim=-1)
    return _triplet_margin(d_ap, d_an, margin, per_example)


def _svalue_l1(q_sents: MultiVec, p_sents: MultiVec,
               per_example: bool = False) -> torch.Tensor:
    """L1 norm of singular values of the cross-doc similarity matrix
    (sparsity regularizer, disent_models.py:459-467)."""
    pair_sims = -pairwise_l2(q_sents.embed, p_sents.embed)
    terms = torch.linalg.svdvals(pair_sims).abs().sum(dim=-1)
    return terms if per_example else terms.sum()


def _feats_args(feats: dict) -> tuple:
    return (feats["token_ids"], feats["attn_mask"], feats["sent_ids"])


def draw_step_rng(rng: torch.Generator | None, batch_size: int,
                  need_perm: bool):
    """One micro batch's random draws, in a fixed order: three 64-bit dropout
    seeds (query, positive, negative encode) and, if asked, the permutation
    that makes in-batch negatives.  Without a generator: no seeds (a training
    pass with dropout then raises in the encoder) and no permutation."""
    if rng is None:
        if need_perm:
            raise ValueError("in-batch negatives need a torch.Generator")
        return (None, None, None), None
    seeds = torch.randint(0, 2 ** 63 - 1, (3,), generator=rng,
                          dtype=torch.int64).tolist()
    perm = torch.randperm(batch_size, generator=rng) if need_perm else None
    return tuple(seeds), perm


def _flatten(tree, n: int):
    """[n_micro, gb, ...] leaves -> [n_micro * gb, ...]."""
    if isinstance(tree, dict):
        return {k: _flatten(v, n) for k, v in tree.items()}
    return tree.reshape((n,) + tuple(tree.shape[2:]))


def _leading_shape(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tuple(tree.shape[:2])


class _DocModelBase(nn.Module):
    """What every model family shares: the loss of a micro batch and the
    grouped loss over an accumulation window, built from `encode` and the
    family's per-example loss terms (`_example_losses`)."""

    def train_loss(self, batch: dict, rng: torch.Generator | None = None,
                   train: bool = True) -> torch.Tensor:
        """Triplet loss over (query, pos, neg-or-in-batch-negatives).

        batch: {'query': feats, 'pos': feats [+ 'align' int[b,2]],
                optional 'neg': feats} (dev sets carry explicit negatives).
        """
        self.train(train)
        has_neg = "neg" in batch
        b = batch["query"]["token_ids"].shape[0]
        seeds, perm = draw_step_rng(rng if (train or not has_neg) else None,
                                    b, not has_neg)
        reps = self._encode_triple(batch, seeds, has_neg)
        return self._group_loss(batch, reps, perm).sum()

    def train_loss_grouped(self, superbatch: dict,
                           rng: torch.Generator | None = None,
                           train: bool = True):
        """Fused gradient accumulation: one wide encode + per-group losses.

        superbatch: nested dict whose tensors lead with [n_micro, micro_batch,
        ...].  Encodes all n_micro * micro examples as ONE batch, then applies
        each micro batch's loss, with its own group-local in-batch-negative
        permutation drawn as `train_loss` would draw it, and sums.  The
        gradient of the sum equals the summed micro-batch gradients: same
        group structure, same reductions, same permutations.  Dropout masks
        differ from the sequential path (one wide encode, keyed on the first
        group's seeds).  Every loss term is a sum over examples, so the
        groups are not walked one by one (the OT solver's loop is launched
        from the host, round by round): the per-example terms of the whole
        wide batch are taken in one call -- the OT solver annealing each group
        from its own diameter (`grouped_max_diameter`) -- and summed group by group.

        Returns (summed loss, per-group losses [n_micro]).
        """
        self.train(train)
        n_micro, gb = _leading_shape(superbatch)
        has_neg = "neg" in superbatch
        draws = [draw_step_rng(rng if (train or not has_neg) else None, gb,
                               not has_neg) for _ in range(n_micro)]
        flat = _flatten(superbatch, n_micro * gb)
        reps = self._encode_triple(flat, draws[0][0], has_neg)
        perm = None
        if not has_neg:
            # group-local permutations as one index into the wide batch
            perm = torch.cat([g * gb + draws[g][1] for g in range(n_micro)])
        terms = self._group_loss(flat, reps, perm, groups=n_micro)
        losses = terms.reshape(n_micro, gb).sum(dim=1)
        return losses.sum(), losses

    def _encode_triple(self, batch, seeds, has_neg):
        """-> [q_cls, q_sents, p_cls, p_sents, n_cls, n_sents]; the negative
        entries are None when the batch carries none."""
        q_cls, q_sents = self.encode(batch["query"], seed=seeds[0])
        p_cls, p_sents = self.encode(batch["pos"], seed=seeds[1])
        n_cls = n_sents = None
        if has_neg:
            n_cls, n_sents = self.encode(batch["neg"], seed=seeds[2])
        return [q_cls, q_sents, p_cls, p_sents, n_cls, n_sents]

    def _group_loss(self, batch, reps, perm, groups: int = 1):
        """Per-example loss terms [b] of a batch that holds `groups` micro
        batches one after the other; `perm` indexes the whole batch."""
        q_cls, q_sents, p_cls, p_sents, n_cls, n_sents = reps
        if perm is not None:
            perm = perm.to(p_cls.device)
            n_cls = p_cls[perm]
            if p_sents is not None:
                n_sents = MultiVec(embed=p_sents.embed[perm],
                                   lens=p_sents.lens[perm])
        return self._example_losses(batch, q_cls, q_sents, p_cls, p_sents,
                                    n_cls, n_sents, perm, groups)

    def _combine_losses(self, batch, q_cls, q_sents, p_cls, p_sents,
                        n_cls, n_sents, perm):
        """The batch's loss, as the JAX package's method of this name."""
        return self._example_losses(batch, q_cls, q_sents, p_cls, p_sents,
                                    n_cls, n_sents, perm).sum()

    def _dist(self, query, cand, groups: int = 1):
        """The model's distance.  OT anneals from a batch-wide diameter, the
        one distance that couples a batch's examples: over several micro
        batches it is given each group's own."""
        if groups > 1 and self.ot_dist:
            return self.dist_fn(query, cand, diameter_value=grouped_max_diameter(
                query.embed, cand.embed, groups))
        return self.dist_fn(query, cand)

    def _sent_triplet(self, q_sents, p_sents, n_sents, groups):
        return _triplet_margin(self._dist(q_sents, p_sents, groups),
                               self._dist(q_sents, n_sents, groups),
                               per_example=True)


class ConSentDocModel(_DocModelBase):
    """Shared skeleton for the contextual-sentence models
    (miswordbienc / sbalisentbienc / miswordpolyenc)."""

    def __init__(self, hp: ModelHParams, bert_config: BertConfig,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.hp = hp
        self.bert_config = bert_config
        self.encoder = ConSentEncoder(
            bert_config, max_sents=hp.max_sents, dtype=dtype,
            attention_impl=hp.attention_impl, ffn_impl=hp.ffn_impl,
            device=require_device(device),
            hidden_dropout_impl=hp.hidden_dropout_impl)
        # get_dist_function aliases l2lse -> l2max itself (the reference's
        # caching_score does the same remap, disent_models.py:294-297)
        self.dist_fn = get_dist_function(hp.score_aggregation, hp)
        if hp.model_name == "miswordpolyenc":
            self.dist_fn = get_dist_function("jointsm", hp)
        self.ot_dist = (hp.score_aggregation == "l2wasserstein"
                        and hp.model_name != "miswordpolyenc")
        self.sent_loss_prop = float(hp.sent_loss_prop)
        self.abs_loss_prop = float(hp.abs_loss_prop)
        self.sentsup_loss_prop = float(hp.sentsup_loss_prop)
        self.cd_svalue_l1_prop = float(hp.cd_svalue_l1_prop)
        # SCORE-time proportions are not the training mix: the base
        # WordSentAlignBiEnc pins sent=1.0 / abs=0.0 at __init__
        # (disent_models.py:253-254) regardless of hparams; subclasses
        # override below per their reference counterparts.
        self.score_sent_prop = 1.0
        self.score_abs_prop = 0.0

    # ---- encode ----
    def encode(self, feats: dict, seed: int | None = None):
        """-> (doc_cls f32[b, h], MultiVec sentence reps).  Dropout follows the
        module's train()/eval() mode; a training pass needs `seed`."""
        cls, sents = self.encoder(*_feats_args(feats), seed=seed)
        return cls, MultiVec(embed=sents, lens=feats["abs_lens"])

    # ---- test-time scoring from cached reps ----
    def score_reps(self, q_cls, q_sents: MultiVec, c_cls, c_sents: MultiVec):
        """Similarity scores (higher = more similar), reference caching_score
        semantics (disent_models.py:294-307): sent-level sims scaled by the
        score-time sentence proportion plus optional CLS-distance term."""
        sims, pair = self.dist_fn(q_sents, c_sents, return_pair_sims=True)
        if self.hp.model_name == "miswordpolyenc":
            # WordSentAlignPolyEnc.caching_score negates the joint-sm
            # negscore and applies NO loss-prop scaling
            # (disent_models.py:902-906); jointsm_dist returns the negscore
            return -sims, pair
        scores = self.score_sent_prop * sims
        if self.score_abs_prop > 0.0:
            doc_sims = -torch.linalg.vector_norm(q_cls - c_cls + 1e-6, dim=-1)
            scores = scores + self.score_abs_prop * doc_sims
        return scores, pair

    # ---- training ----
    def _example_losses(self, batch, q_cls, q_sents, p_cls, p_sents,
                        n_cls, n_sents, perm, groups: int = 1):
        loss = self._sent_triplet(q_sents, p_sents, n_sents, groups)
        if self.cd_svalue_l1_prop > 0 and perm is not None:
            loss = loss + self.cd_svalue_l1_prop * _svalue_l1(q_sents, p_sents, True)
        return loss


class WordSentAlignModel(ConSentDocModel):
    """miswordbienc / miswordpolyenc (disent_models.py:208-535,840-925)."""


class WordSentAbsAlignModel(ConSentDocModel):
    """miswordabsbienc: sentence-distance triplet + abstract-CLS triplet with
    an optional L1 sparsity penalty on the cross-doc similarity matrix
    (WordSentAbsAlignBiEnc, disent_models.py:538-660)."""

    def __init__(self, hp: ModelHParams, bert_config: BertConfig,
                 dtype=torch.float32, device="cuda"):
        super().__init__(hp, bert_config, dtype, device)
        # this family scores with its hparam proportions
        # (WordSentAbsAlignBiEnc.__init__, disent_models.py:583-584)
        self.score_sent_prop = float(hp.sent_loss_prop)
        self.score_abs_prop = float(hp.abs_loss_prop)

    def _example_losses(self, batch, q_cls, q_sents, p_cls, p_sents,
                        n_cls, n_sents, perm, groups: int = 1):
        loss = self.sent_loss_prop * self._sent_triplet(q_sents, p_sents,
                                                        n_sents, groups)
        loss = loss + self.abs_loss_prop * _cls_l2_triplet(
            q_cls, p_cls, n_cls, per_example=True)
        cd_l1 = float(self.hp.cd_l1_prop)
        if cd_l1 > 0 and perm is not None:
            pair_sims = -pairwise_l2(q_sents.embed, p_sents.embed)
            sims_norm = pair_sims.reshape(pair_sims.shape[0], -1).abs().sum(dim=1)
            loss = loss + cd_l1 * sims_norm
        return loss


class WordSentAbsSupAlignModel(ConSentDocModel):
    """sbalisentbienc: tsAspire/ts+otAspire with pre-aligned sentence
    supervision (disent_models.py:663-837)."""

    def __init__(self, hp: ModelHParams, bert_config: BertConfig,
                 dtype=torch.float32, device="cuda"):
        super().__init__(hp, bert_config, dtype, device)
        self.sup_fn = l2sup_weighted_dist if hp.weighted_sup else l2sup_dist
        # caching_score uses max(sent, sentsup) for this family
        # (disent_models.py:299-304, 714-716) + the hparam abs term
        self.score_sent_prop = max(float(hp.sent_loss_prop),
                                   float(hp.sentsup_loss_prop))
        self.score_abs_prop = float(hp.abs_loss_prop)

    def _example_losses(self, batch, q_cls, q_sents, p_cls, p_sents,
                        n_cls, n_sents, perm, groups: int = 1):
        cls_triplet = lambda: self.abs_loss_prop * _cls_l2_triplet(
            q_cls, p_cls, n_cls, per_example=True)
        if perm is None:
            # Dev set: "predictions" not pre-alignments (disent_models.py:796-801).
            loss = self._sent_triplet(q_sents, p_sents, n_sents, groups)
            if self.abs_loss_prop > 0:
                loss = loss + cls_triplet()
            return loss
        pos_align = batch["pos"]["align"]
        neg_align = pos_align[perm]
        p_ali = MultiVec(embed=p_sents.embed, lens=p_sents.lens, align=pos_align)
        n_ali = MultiVec(embed=n_sents.embed, lens=n_sents.lens, align=neg_align)
        loss = self.sentsup_loss_prop * _triplet_margin(
            self.sup_fn(q_sents, p_ali), self.sup_fn(q_sents, n_ali),
            per_example=True)
        if self.sent_loss_prop > 0:
            loss = loss + self.sent_loss_prop * self._sent_triplet(
                q_sents, p_sents, n_sents, groups)
        if self.abs_loss_prop > 0:
            loss = loss + cls_triplet()
        if self.cd_svalue_l1_prop > 0:
            loss = loss + self.cd_svalue_l1_prop * _svalue_l1(q_sents, p_sents, True)
        return loss


class SpecterDocModel(_DocModelBase):
    """cospecter: CLS bi-encoder with scalar layer mix (disent_models.py:24-205)."""

    def __init__(self, hp: ModelHParams, bert_config: BertConfig,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.hp = hp
        self.bert_config = bert_config
        self.encoder = BiEncoder(
            bert_config, dtype=dtype, attention_impl=hp.attention_impl,
            ffn_impl=hp.ffn_impl, device=require_device(device),
            hidden_dropout_impl=hp.hidden_dropout_impl)

    def encode(self, feats: dict, seed: int | None = None):
        return self.encoder(feats["token_ids"], feats["attn_mask"],
                            seed=seed), None

    def score_reps(self, q_cls, q_sents, c_cls, c_sents):
        """-L2 distance between CLS reps (disent_models.py:76)."""
        scores = -torch.linalg.vector_norm(q_cls - c_cls, dim=-1)
        return scores, scores

    def _example_losses(self, batch, q_cls, q_sents, p_cls, p_sents,
                        n_cls, n_sents, perm, groups: int = 1):
        return _cls_l2_triplet(q_cls, p_cls, n_cls, per_example=True)


def _sent_models():
    from .sent_models import ICTModel, SentTripleModel
    return {"cosentbert": SentTripleModel, "ictsentbert": ICTModel}


MODEL_REGISTRY = {
    "cospecter": SpecterDocModel,
    "miswordbienc": WordSentAlignModel,
    "miswordabsbienc": WordSentAbsAlignModel,
    "miswordpolyenc": WordSentAlignModel,
    "sbalisentbienc": WordSentAbsSupAlignModel,
}


def build_model(hp: ModelHParams, bert_config: BertConfig,
                dtype=torch.float32, device="cuda"):
    """Model factory keyed by the reference registries (main_fsim.py:91-99,
    main_sentsim.py -- cosentbert/ictsentbert included)."""
    registry = {**MODEL_REGISTRY, **_sent_models()}
    try:
        cls = registry[hp.model_name]
    except KeyError:
        raise ValueError(f"Unknown model: {hp.model_name}") from None
    return cls(hp, bert_config, dtype, device)
