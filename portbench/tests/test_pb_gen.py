"""The seeded generators repeat exactly, and lay the index out as the
program's buckets hold it."""
import numpy as np
import torch

from portbench.lib import gen, weights
from portbench.tests import tiny

CPU = torch.device("cpu")


def test_abstracts_repeat():
    a = gen.abstracts(5, "q", 6, tiny.ABSTRACTS, 200, 24)
    b = gen.abstracts(5, "q", 6, tiny.ABSTRACTS, 200, 24)
    c = gen.abstracts(6, "q", 6, tiny.ABSTRACTS, 200, 24)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["token_ids"], c["token_ids"])
    # every kept sentence is whole, inside the mask, numbered from 0
    for i in range(6):
        ids = a["sent_ids"][i]
        assert ids.max() == a["lens"][i] - 1
        assert a["attn_mask"][i].sum() == a["tokens"][i]
        assert (a["attn_mask"][i][ids >= 0] == 1).all()
        assert a["token_ids"][i, 0] == gen.CLS


def test_int8_index_repeats_and_layout():
    a = gen.int8_index(9, 300, tiny.INDEX, 64, CPU)
    b = gen.int8_index(9, 300, tiny.INDEX, 64, CPU)
    for x, y in zip(a["buckets"], b["buckets"]):
        for k in x:
            assert torch.equal(x[k], y[k])
    lens = a["lens"]
    db, dr, dl = a["pos"]
    assert torch.equal(dl, lens)
    for bi, bk in enumerate(a["buckets"]):
        n, s, _ = bk["sents"].shape
        assert n % 8 == 0
        live = bk["doc_idx"] >= 0
        docs = bk["doc_idx"][live].long()
        assert (db[docs] == bi).all() and (lens[docs] <= s).all()
        assert torch.equal(dr[docs], torch.nonzero(live).flatten().int())
        slot = torch.arange(s)[None, :] < torch.zeros(n, dtype=torch.long).index_put(
            (torch.nonzero(live).flatten(),), lens[docs].long())[:, None]
        x = bk["sents"].float() * bk["scales"][..., None]
        assert torch.allclose(bk["norms"][slot], (x * x).sum(-1)[slot], rtol=1e-5)
        assert torch.isinf(bk["norms"][~slot]).all()
        assert (bk["sents"][~slot] == 0).all()


def test_pools_and_weights_repeat():
    t = tiny.TRAFFIC["aspire-pool-ot"]
    p = gen.pools(3, "p", 2, t, 200, 64, CPU)
    q = gen.pools(3, "p", 2, t, 200, 64, CPU)
    assert torch.equal(p["cand_ids"], q["cand_ids"]) and torch.equal(p["q"], q["q"])
    for row in p["cand_ids"]:
        live = row[row >= 0]
        assert live.unique().numel() == live.numel() >= t["pool_live_min"]
    cfg = {**tiny.CONFIG, "type_vocab_size": 2}
    assert torch.equal(weights.draw(cfg, 4, CPU), weights.draw(cfg, 4, CPU))
    assert not torch.equal(weights.draw(cfg, 4, CPU), weights.draw(cfg, 5, CPU))


def test_sub_seeds_take_large_seeds():
    assert gen.sub_seed(2**31 + 12345, "x") != gen.sub_seed(2**31 + 12346, "x")
    assert 0 <= gen.sub_seed(2**64 - 1, "x") < 2**63
