"""Search traffic: query papers answered over a multi-vector int8 index by
the fused query of `aspire_tpu_torch.index.serve` (the l2max scan, the
candidates' gather on the card, the OT rerank).

Traffic parameters (`traffic/<name>.json`):
  entry: "batched" (`make_fused_query_batched` on `batch` new abstracts, put
      through `ConSentEncoder` first; also seq, sentences, sentence_tokens,
      see lib/gen.abstracts) or "single" (`make_fused_query` on one indexed
      paper's sentence reps, as f32)
  k, index {docs, buckets, sentences}, distinct_batches (the inputs are
  cycled), check_batches (entry calls compared with the reference),
  trace_calls (calls under the profiler).
The loop is closed: the next call is made when the last one's results are
on the host."""
from __future__ import annotations

import numpy as np
import torch

from portbench.lib import compare, gen, weights
from portbench.lib.spans import Phases, Spans
from portbench.lib.work import schedule_len
from portbench.reference import bert as ref_bert
from portbench.reference import ot as ref_ot
from portbench.reference import search as ref_search


def setup(cfg: dict, traffic: dict, seed: int, device):
    return FusedQuery(cfg, traffic, seed, device)


class FusedQuery:
    def __init__(self, cfg, traffic, seed, device):
        from aspire_tpu_torch.index.dense import flatten_device_buckets
        from aspire_tpu_torch.index.serve import (make_fused_query,
                                                  make_fused_query_batched)
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.spans = Spans(device)
        self.setup_phases = phases = Phases(device)
        ix = traffic["index"]
        self.sizes = ix["buckets"]
        self.index = gen.int8_index(seed, ix["docs"], ix, cfg["hidden_size"], device)
        phases.mark("index")
        self.flat = flatten_device_buckets(self.index["buckets"])
        self.k, self.max_sents = traffic["k"], cfg["max_sents"]
        rr = cfg["rerank"]
        kw = dict(int8=True, blur=rr["blur"], scaling=rr["scaling"],
                  temp=rr["temp"], max_iters=rr["max_iters"])
        n_b = len(self.index["buckets"])
        self.single = traffic["entry"] == "single"
        self.fn = (make_fused_query(n_b, self.k, self.max_sents, **kw) if self.single
                   else make_fused_query_batched(n_b, self.k, self.max_sents, **kw))
        self.bsz = 1 if self.single else traffic["batch"]
        self.n_slots = traffic["distinct_batches"]
        n_q = self.n_slots * self.bsz
        self.encoder = not self.single
        if self.encoder:
            self._setup_encoder(n_q)
        else:
            self._setup_indexed(n_q)
        phases.mark("encoder and queries" if self.encoder else "queries")
        self.kept: dict = {}
        for i in range(traffic.get("warmup_calls", 3)):
            self.step(i)
        self.kept.clear()
        phases.mark("warm-up")

    # ---------------------------------------------------------------- set-up
    def _setup_encoder(self, n_q: int) -> None:
        from aspire_tpu_torch.models.encoders import ConSentEncoder
        cfg, dev = self.cfg, self.device
        self.w = weights.draw(cfg, self.seed, dev)
        self.model = ConSentEncoder(weights.program_config(cfg), max_sents=self.max_sents,
                                    dtype=torch.bfloat16, device=dev)
        weights.load_into(self.model, self.w, cfg)
        self.model.eval()
        self.docs = gen.abstracts(self.seed, "queries", n_q, self.traffic,
                                  cfg["vocab_size"], self.max_sents)
        pin = dev.type == "cuda"
        self.inputs = []
        for s in range(self.n_slots):
            rows = slice(s * self.bsz, (s + 1) * self.bsz)
            t = [torch.from_numpy(self.docs[n][rows]) for n in
                 ("token_ids", "attn_mask", "sent_ids")]
            self.inputs.append([x.pin_memory() if pin else x for x in t])
        self.q_lens = [torch.from_numpy(self.docs["lens"][s * self.bsz:(s + 1) * self.bsz])
                       .to(dev) for s in range(self.n_slots)]
        self.q_lens_host = self.docs["lens"]

    def _setup_indexed(self, n_q: int) -> None:
        rng = np.random.default_rng(gen.sub_seed(self.seed, "query-docs"))
        n_docs = self.index["lens"].numel()
        self.query_docs = torch.from_numpy(
            rng.choice(n_docs, n_q, replace=False)).to(self.device)
        self.q, lens = self.gather(self.query_docs)
        self.q_lens_host = lens.cpu().numpy()

    def gather(self, ids: torch.Tensor):
        """Documents' sentence reps as the index stores them, dequantised by
        the reference's own reading of the index, zero-padded to max_sents:
        (f32 [n, max_sents, d], lens [n])."""
        idx = self.index
        bucket, row = ref_search.locate(idx["lens"].long(), self.sizes)
        ids = ids.long()
        lens = torch.clamp_max(idx["lens"][ids].long(), self.max_sents)
        out = torch.zeros((ids.numel(), self.max_sents, self.cfg["hidden_size"]),
                          device=self.device)
        for bi, b in enumerate(idx["buckets"]):
            sel = torch.nonzero(bucket[ids] == bi).flatten()
            if sel.numel() == 0:
                continue
            s = min(b["sents"].shape[1], self.max_sents)
            r = row[ids[sel]]
            x = ref_search.dequantise(b["sents"][r, :s], b["scales"][r, :s])
            live = torch.arange(s, device=self.device)[None, :] < lens[sel, None]
            out[sel, :s] = x * live[:, :, None]
        return out, lens

    # ---------------------------------------------------------------- a call
    def step(self, i: int):
        slot = i % self.n_slots
        sp = self.spans
        with torch.no_grad():
            if self.encoder:
                with sp("encode"):
                    ids, mask, sent = (x.to(self.device, non_blocking=True)
                                       for x in self.inputs[slot])
                    _, q = self.model(ids, mask, sent)
                q_lens = self.q_lens[slot]
            else:
                q, q_lens = self.q[slot], int(self.q_lens_host[slot])
            with sp("search"):
                v, d, s = self.fn(q, q_lens, *self.flat, *self.index["pos"])
            with sp("read"):
                v, d, s = v.cpu(), d.cpu(), s.cpu()
        if self.single:
            v, d, s = v[None], d[None], s[None]
        self.kept[slot] = (q if self.encoder else None, v, d, s)
        return self.bsz

    def failed(self, i: int) -> int:
        """Queries of call i whose answer holds a non-finite score or a pad id."""
        v, d, s = (x.numpy() for x in self.kept[i % self.n_slots][1:])
        ok = np.isfinite(v).all(1) & np.isfinite(s).all(1) & (d >= 0).all(1)
        return int((~ok).sum())

    def free_program(self) -> None:
        """Drop the program's state (model, cast weights, entry)."""
        for name in ("model", "fn", "flat"):
            self.__dict__.pop(name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------ work
    def work(self, i: int) -> dict:
        slot = i % self.n_slots
        cfg, rr = self.cfg, self.cfg["rerank"]
        q, q_lens = self._query(slot)
        _, _, d, _ = self.kept[slot]
        cands, c_lens = self.gather(d.flatten().to(self.device))
        qt, ql = _tile(q, q_lens, self.k)
        diam = ref_ot.diameters(qt, cands, None, None, groups=q.shape[0])
        out = {"scan": {"q_sents": q_lens.cpu().tolist(), "qmax": q.shape[1],
                        "dim": cfg["hidden_size"],
                        "buckets": [list(b["sents"].shape[:2]) for b in self.index["buckets"]],
                        "doc_sents": int(self.index["lens"].sum())},
               "rerank": {"n": ql.cpu().tolist(), "m": c_lens.cpu().tolist(),
                          "n_pad": q.shape[1], "m_pad": self.max_sents,
                          "iters": schedule_len(diam.cpu().numpy(), rr["blur"],
                                                rr["scaling"], rr["max_iters"]).tolist(),
                          "dim": cfg["hidden_size"]}}
        if self.encoder:
            rows = slice(slot * self.bsz, (slot + 1) * self.bsz)
            out["encoder"] = {"tokens": self.docs["tokens"][rows].tolist(),
                              "seq": self.traffic["seq"], "layers": cfg["num_hidden_layers"],
                              "hidden": cfg["hidden_size"], "ffn": cfg["intermediate_size"],
                              "heads": cfg["num_attention_heads"]}
        return out

    def _query(self, slot: int):
        """The query reps the call scored, [B, qmax, d], and their lens."""
        if self.encoder:
            return self.kept[slot][0].float(), self.q_lens[slot]
        rows = slice(slot * self.bsz, (slot + 1) * self.bsz)
        return self.q[rows], torch.as_tensor(self.q_lens_host[rows], device=self.device)

    # ----------------------------------------------------------------- check
    def check(self, lower: bool = False) -> dict:
        """The worst gaps over a sample of the window's calls, drawn from the
        seed.  lower=True judges the control in the program's place: the
        reference with an fp8 encoder, an int4 scan and a bf16 solve."""
        rng = np.random.default_rng(gen.sub_seed(self.seed, "check"))
        slots = sorted(self.kept)
        pick = rng.choice(slots, min(self.traffic["check_batches"], len(slots)),
                          replace=False)
        worst: dict = {}
        for slot in sorted(int(s) for s in pick):
            for name, value in self._check_slot(slot, lower).items():
                worst[name] = max(worst.get(name, 0.0), value)
        return worst

    def _check_slot(self, slot: int, lower: bool) -> dict:
        cfg, rr = self.cfg, self.cfg["rerank"]
        out = {}
        with torch.no_grad():
            if self.encoder:
                rows = slice(slot * self.bsz, (slot + 1) * self.bsz)
                w = weights.views(self.w, cfg)
                ids, mask, sent = (x.to(self.device) for x in self.inputs[slot])
                want = ref_bert.sentence_reps(w, cfg, ids, mask, sent, self.max_sents)
                q = (ref_bert.sentence_reps(w, cfg, ids, mask, sent, self.max_sents,
                                            lower=True) if lower
                     else self.kept[slot][0].float())
                q_lens = self.q_lens[slot]
                real = (torch.arange(self.max_sents, device=self.device)[None, :]
                        < q_lens[:, None])
                out["sent_reps_gap"] = compare.worst_row_gap(q[real], want[real])
                del want
            else:
                q, q_lens = self._query(slot)
            buckets = self.index["buckets"]
            ref_d2 = ref_search.doc_distances(q, q_lens, buckets, self.index["lens"],
                                              self.sizes)
            if lower:
                d2 = ref_search.doc_distances(q, q_lens, buckets, self.index["lens"],
                                              self.sizes, bits=4)
                top = torch.topk(-d2, self.k, dim=1)
                ids, scores = top.indices, -torch.sqrt(-top.values)
            else:
                _, scores, ids, sims = self.kept[slot]
            out["stage1_gap"] = compare.first_stage_gap(scores, ids, ref_d2)
            del ref_d2
            cands, c_lens = self.gather(ids.flatten().to(self.device))
            qt, ql = _tile(q, q_lens, self.k)
            args = (qt, ql, cands, c_lens, rr["temp"], rr["blur"], rr["scaling"],
                    rr["max_iters"], q.shape[0])
            want = ref_ot.scores(*args)
            got = ref_ot.scores(*args, dtype=torch.bfloat16) if lower else sims
            out["ot_gap"] = compare.score_gap(got, want)
        return out


def _tile(q: torch.Tensor, q_lens: torch.Tensor, k: int):
    """[B, qmax, d], [B] -> each query repeated for its k candidates."""
    bsz = q.shape[0]
    qt = q[:, None].expand(bsz, k, *q.shape[1:]).reshape(bsz * k, *q.shape[1:])
    return qt, q_lens.long()[:, None].expand(bsz, k).reshape(-1)
