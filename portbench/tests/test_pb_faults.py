"""A run whose timed path is broken underneath comes out not correct: an
answer altered where it is produced, half of a batch left out."""
import pytest
import torch

from portbench.tests import tiny


def _wrap_fn(state, change):
    fn = state.fn

    def broken(*args):
        return change(args, *fn(*args))
    state.fn = broken


def alter_first_id(state):
    def change(args, v, d, s):
        d = d.clone()
        flat = d.view(-1)
        flat[0] = (flat[0] + 1) % state.index["lens"].numel()
        return v, d, s
    _wrap_fn(state, change)


def alter_one_ot_score(state):
    """The last candidate's OT score 2% off (the first is often the query's
    own paper, whose score is near 0)."""
    def change(args, v, d, s):
        s = s.clone()
        s.view(-1)[-1] *= 1.02
        return v, d, s
    _wrap_fn(state, change)


def drop_half_of_the_queries(state):
    """The second half of a batch answered with the first half's answers."""
    def change(args, v, d, s):
        h = v.shape[0] // 2
        return tuple(torch.cat([x[:h], x[:v.shape[0] - h]]) for x in (v, d, s))
    _wrap_fn(state, change)


def alter_one_sentence(state):
    model = state.model

    def broken(*args):
        cls, reps = model(*args)
        reps = reps.clone()
        reps[0, 0] *= 1.1
        return cls, reps
    state.model = broken


def alter_one_pool_score(state):
    fn = state.fn

    def broken(*args):
        sims = fn(*args).clone()
        sims[0, 0] *= 1.01
        return sims
    state.fn = broken


def score_a_pad_slot(state):
    fn = state.fn

    def broken(q, q_lens, cand, *rest):
        sims = fn(q, q_lens, cand, *rest).clone()
        sims[cand < 0] = 0.0
        return sims
    state.fn = broken


def drop_half_of_the_pools(state):
    fn = state.fn

    def broken(*args):
        sims = fn(*args)
        h = sims.shape[0] // 2
        return torch.cat([sims[:h], sims[:sims.shape[0] - h]])
    state.fn = broken


def alter_one_cls(state):
    model = state.model

    def broken(*args):
        cls = model(*args).clone()
        cls[0] *= 1.1
        return cls
    state.model = broken


def drop_half_of_the_docs(state):
    """The second half of a batch left out: no vectors for it (zeros).  (A
    copy of another document's vector reads 0.04 or more at the cell's own
    size, where documents' vectors lie 4.6% of their norm apart; at this
    test's size they lie within 0.3%.)"""
    model = state.model

    def broken(ids, mask):
        h = ids.shape[0] // 2
        cls = model(ids[:h], mask[:h])
        return torch.cat([cls, torch.zeros_like(cls[:ids.shape[0] - h])])
    state.model = broken


FAULTS = [
    ("aspire-1m-b32", alter_one_sentence), ("aspire-1m-b32", alter_first_id),
    ("aspire-1m-b32", alter_one_ot_score), ("aspire-1m-b32", drop_half_of_the_queries),
    ("aspire-1m-b1", alter_first_id), ("aspire-1m-b1", alter_one_ot_score),
    ("aspire-pool-ot", alter_one_pool_score), ("aspire-pool-ot", score_a_pad_slot),
    ("aspire-pool-ot", drop_half_of_the_pools),
    ("cospecter-encode-b128", alter_one_cls), ("cospecter-encode-b128", drop_half_of_the_docs),
]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_path_is_not_correct(cell, fault):
    assert tiny.run(cell)["correct"]
    assert not tiny.run(cell, faults=fault)["correct"]
