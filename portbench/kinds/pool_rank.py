"""Pool re-ranking traffic (the TRECCOVID-RF protocol): each query scored
against exactly its candidate pool by `index.serve.make_pool_rank_batched`,
the candidates gathered on the card from a dense bucket by id, OT with a
diameter a pair.

Traffic parameters (`traffic/<name>.json`): bucket {docs, sentences} (one
bf16 bucket, every document that many sentences), batch (queries a call),
query_sents, pool (slots a query), pool_live_min (a query's live slots are
drawn from [pool_live_min, pool], the rest pad), distinct_batches,
check_batches, trace_calls.  Closed loop."""
from __future__ import annotations

import numpy as np
import torch

from portbench.lib import compare, gen
from portbench.lib.spans import Phases, Spans
from portbench.lib.work import schedule_len
from portbench.reference import ot as ref_ot

NEG = -1e30


def setup(cfg: dict, traffic: dict, seed: int, device):
    return PoolRank(cfg, traffic, seed, device)


class PoolRank:
    def __init__(self, cfg, traffic, seed, device):
        from aspire_tpu_torch.index.serve import make_pool_rank_batched
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.spans = Spans(device)
        self.setup_phases = phases = Phases(device)
        bk = traffic["bucket"]
        self.index = gen.bf16_bucket(seed, bk["docs"], bk["sentences"],
                                     cfg["hidden_size"], device)
        phases.mark("bucket")
        b = self.index["buckets"][0]
        self.flat = [b["sents"], b["norms"], b["doc_idx"]]
        rr = cfg["rerank"]
        self.max_sents = cfg["max_sents"]
        self.fn = make_pool_rank_batched(
            1, traffic["pool"], self.max_sents, agg="ot", blur=rr["blur"],
            scaling=rr["scaling"], temp=rr["temp"], max_iters=rr["max_iters"])
        self.bsz, self.n_slots = traffic["batch"], traffic["distinct_batches"]
        self.queries = [gen.pools(seed, f"pools-{s}", self.bsz, traffic, bk["docs"],
                                  cfg["hidden_size"], device)
                        for s in range(self.n_slots)]
        phases.mark("pools")
        self.kept: dict = {}
        for i in range(traffic.get("warmup_calls", 3)):
            self.step(i)
        self.kept.clear()
        phases.mark("warm-up")

    def step(self, i: int):
        slot = i % self.n_slots
        qs = self.queries[slot]
        with torch.no_grad():
            with self.spans("rank"):
                sims = self.fn(qs["q"], qs["q_lens"], qs["cand_ids"], *self.flat,
                               *self.index["pos"])
            with self.spans("read"):
                sims = sims.cpu()
        self.kept[slot] = sims
        return self.bsz

    def failed(self, i: int) -> int:
        """Queries of call i whose scores are not all finite."""
        return int((~np.isfinite(self.kept[i % self.n_slots].numpy()).all(1)).sum())

    def free_program(self) -> None:
        for name in ("fn", "flat"):
            self.__dict__.pop(name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _pairs(self, slot: int):
        """The live pairs of a call: (query index, candidate id, slot index)
        as flat tensors, and their reps as the reference reads them."""
        qs = self.queries[slot]
        cand = qs["cand_ids"]
        live = torch.nonzero(cand >= 0)
        qi, ids = live[:, 0], cand[live[:, 0], live[:, 1]].long()
        b = self.index["buckets"][0]
        s = min(b["sents"].shape[1], self.max_sents)
        c = torch.zeros((ids.numel(), self.max_sents, b["sents"].shape[2]),
                        device=self.device)
        c[:, :s] = b["sents"][ids, :s].float()
        c_lens = torch.clamp_max(self.index["lens"][ids].long(), self.max_sents)
        return live, qs["q"][qi], qs["q_lens"][qi].long(), c, c_lens

    def work(self, i: int) -> dict:
        rr = self.cfg["rerank"]
        _, q, ql, c, cl = self._pairs(i % self.n_slots)
        a = (torch.arange(q.shape[1], device=self.device)[None] < ql[:, None]).float()
        b = (torch.arange(c.shape[1], device=self.device)[None] < cl[:, None]).float()
        diam = ref_ot.diameters(q, c, a, b, None)
        return {"rerank": {"n": ql.cpu().tolist(), "m": cl.cpu().tolist(),
                           "n_pad": q.shape[1], "m_pad": self.max_sents,
                           "iters": schedule_len(diam.cpu().numpy(), rr["blur"],
                                                 rr["scaling"], rr["max_iters"]).tolist(),
                           "dim": self.cfg["hidden_size"]}}

    def check(self, lower: bool = False) -> dict:
        """Worst gaps over a sample of the window's calls: the live slots'
        OT scores against the reference's (lower=True: the control, the
        reference's solve in bf16), and the slots that are pad in the pool
        and not NEG in the answer, or the other way round (exact)."""
        rr = self.cfg["rerank"]
        rng = np.random.default_rng(gen.sub_seed(self.seed, "check"))
        slots = sorted(self.kept)
        pick = rng.choice(slots, min(self.traffic["check_batches"], len(slots)),
                          replace=False)
        worst = {"pool_ot_gap": 0.0, "pad_mismatch": 0.0}
        for slot in sorted(int(s) for s in pick):
            live, q, ql, c, cl = self._pairs(slot)
            args = (q, ql, c, cl, rr["temp"], rr["blur"], rr["scaling"], rr["max_iters"])
            with torch.no_grad():
                want = ref_ot.scores(*args)
                if lower:
                    got = ref_ot.scores(*args, dtype=torch.bfloat16)
                    answer = torch.full(self.queries[slot]["cand_ids"].shape, NEG)
                    answer[live[:, 0].cpu(), live[:, 1].cpu()] = got.float().cpu()
                else:
                    answer = self.kept[slot]
                    got = answer[live[:, 0].cpu(), live[:, 1].cpu()]
            pad = (self.queries[slot]["cand_ids"] < 0).cpu()
            wrong = (pad & (answer != NEG)) | (~pad & (answer == NEG))
            worst["pool_ot_gap"] = max(worst["pool_ot_gap"], compare.score_gap(got, want))
            worst["pad_mismatch"] = max(worst["pad_mismatch"], float(wrong.sum()))
        return worst
