"""The plain reference against the port at small sizes on the CPU, both in
float32: the encoders, the l2max first stage, the OT scores."""
import torch

from portbench.lib import gen, weights
from portbench.reference import bert as ref_bert
from portbench.reference import ot as ref_ot
from portbench.reference import search as ref_search
from portbench.tests import tiny

CPU = torch.device("cpu")
CFG = {**tiny.CONFIG, "type_vocab_size": 2, "layer_norm_eps": 1e-12,
       "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1}


def _batch():
    docs = gen.abstracts(1, "t", 3, tiny.ABSTRACTS, CFG["vocab_size"], 24)
    return docs, (torch.from_numpy(docs[k]) for k in ("token_ids", "attn_mask", "sent_ids"))


def test_encoders_match_the_port():
    from aspire_tpu_torch.models.encoders import BiEncoder, ConSentEncoder
    flat = weights.draw(CFG, 7, CPU)
    w = weights.views(flat, CFG)
    docs, (ids, mask, sent) = _batch()
    con = ConSentEncoder(weights.program_config(CFG), max_sents=24, device=CPU).eval()
    weights.load_into(con, flat, CFG)
    bi = BiEncoder(weights.program_config(CFG), device=CPU).eval()
    weights.load_into(bi, flat, CFG)
    with torch.no_grad():
        _, got = con(ids, mask, sent)
        want = ref_bert.sentence_reps(w, CFG, ids, mask, sent, 24)
        assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
        assert torch.allclose(bi(ids, mask), ref_bert.mixed_cls(w, CFG, ids, mask),
                              atol=1e-5, rtol=1e-5)


def test_first_stage_matches_the_port():
    from aspire_tpu_torch.index.dense import score_buckets_batched
    idx = gen.int8_index(3, 300, tiny.INDEX, 64, CPU)
    q = torch.randn(3, 5, 64, generator=torch.Generator().manual_seed(1)) * 0.8
    q_lens = torch.tensor([5, 2, 4])
    d2 = ref_search.doc_distances(q, q_lens, idx["buckets"], idx["lens"], tiny.INDEX["buckets"])
    v, d = score_buckets_batched(idx["buckets"], q, q_lens, 10)
    # the port rounds the query to bf16 for the int8 product
    want = torch.gather(d2, 1, d.long())
    assert torch.allclose(-v, want, rtol=2e-2, atol=1e-3)
    # and it reports the reference's ten nearest documents
    nearest = torch.topk(-d2, 10).values.neg()
    assert torch.allclose(want.sort(1).values, nearest, rtol=2e-2, atol=1e-3)


def test_ot_matches_the_port():
    from aspire_tpu_torch.core.types import MultiVec
    from aspire_tpu_torch.ops.distances import wasserstein_dist
    g = torch.Generator().manual_seed(4)
    q = torch.randn(6, 5, 16, generator=g)
    c = torch.randn(6, 7, 16, generator=g)
    ql, cl = torch.tensor([5, 3, 4, 5, 2, 1]), torch.tensor([7, 7, 2, 5, 1, 6])
    q = q * (torch.arange(5)[None] < ql[:, None])[:, :, None]
    c = c * (torch.arange(7)[None] < cl[:, None])[:, :, None]
    want = ref_ot.scores(q, ql, c, cl, temp=5.0, groups=None)
    got, _ = wasserstein_dist(MultiVec(q, ql), MultiVec(c, cl), temp=5.0,
                              return_pair_sims=True, diameter="pair", solver="torch")
    assert torch.allclose(got.double(), want, rtol=1e-4, atol=1e-4)
    # a query's pool annealed from its whole box
    want = ref_ot.scores(q, ql, c, cl, temp=5.0, groups=2)
    from aspire_tpu_torch.ops.sinkhorn import grouped_max_diameter
    got, _ = wasserstein_dist(MultiVec(q, ql), MultiVec(c, cl), temp=5.0,
                              return_pair_sims=True, solver="torch",
                              diameter_value=grouped_max_diameter(q, c, 2))
    assert torch.allclose(got.double(), want, rtol=1e-4, atol=1e-4)
