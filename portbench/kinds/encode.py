"""Corpus encoding traffic: batches of abstracts through the bi-encoder
(`models/encoders.BiEncoder`, the softmax mix of the layers' CLS vectors),
the vectors copied to the host as `index/build.encode_corpus` copies them.

Traffic parameters (`traffic/<name>.json`): batch, seq, sentences,
sentence_tokens (lib/gen.abstracts), distinct_batches, check_batches,
trace_calls.  Closed loop."""
from __future__ import annotations

import numpy as np
import torch

from portbench.lib import compare, gen, weights
from portbench.lib.spans import Phases, Spans
from portbench.reference import bert as ref_bert


def setup(cfg: dict, traffic: dict, seed: int, device):
    return Encode(cfg, traffic, seed, device)


class Encode:
    def __init__(self, cfg, traffic, seed, device):
        from aspire_tpu_torch.models.encoders import BiEncoder
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.spans = Spans(device)
        self.setup_phases = phases = Phases(device)
        self.w = weights.draw(cfg, seed, device)
        self.model = BiEncoder(weights.program_config(cfg), dtype=torch.bfloat16,
                               device=device)
        weights.load_into(self.model, self.w, cfg)
        self.model.eval()
        phases.mark("encoder")
        self.bsz, self.n_slots = traffic["batch"], traffic["distinct_batches"]
        self.docs = gen.abstracts(seed, "corpus", self.bsz * self.n_slots, traffic,
                                  cfg["vocab_size"], cfg.get("max_sents", 24))
        pin = device.type == "cuda"
        self.inputs = []
        for s in range(self.n_slots):
            rows = slice(s * self.bsz, (s + 1) * self.bsz)
            t = [torch.from_numpy(self.docs[n][rows]) for n in ("token_ids", "attn_mask")]
            self.inputs.append([x.pin_memory() if pin else x for x in t])
        phases.mark("abstracts")
        self.kept: dict = {}
        for i in range(traffic.get("warmup_calls", 3)):
            self.step(i)
        self.kept.clear()
        phases.mark("warm-up")

    def step(self, i: int):
        slot = i % self.n_slots
        with torch.no_grad():
            with self.spans("encode"):
                ids, mask = (x.to(self.device, non_blocking=True) for x in self.inputs[slot])
                cls = self.model(ids, mask)
            with self.spans("read"):
                cls = cls.float().cpu().numpy()
        self.kept[slot] = cls
        return self.bsz

    def failed(self, i: int) -> int:
        """Documents of call i whose vector is not all finite."""
        return int((~np.isfinite(self.kept[i % self.n_slots]).all(1)).sum())

    def free_program(self) -> None:
        self.__dict__.pop("model", None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def work(self, i: int) -> dict:
        slot, cfg = i % self.n_slots, self.cfg
        rows = slice(slot * self.bsz, (slot + 1) * self.bsz)
        return {"encoder": {"tokens": self.docs["tokens"][rows].tolist(),
                            "seq": self.traffic["seq"], "layers": cfg["num_hidden_layers"],
                            "hidden": cfg["hidden_size"], "ffn": cfg["intermediate_size"],
                            "heads": cfg["num_attention_heads"]}}

    def check(self, lower: bool = False) -> dict:
        """The worst document's CLS vector against the reference's
        (lower=True: the control, the reference with fp8 products)."""
        rng = np.random.default_rng(gen.sub_seed(self.seed, "check"))
        slots = sorted(self.kept)
        pick = rng.choice(slots, min(self.traffic["check_batches"], len(slots)),
                          replace=False)
        w = weights.views(self.w, self.cfg)
        worst = 0.0
        for slot in sorted(int(s) for s in pick):
            ids, mask = (x.to(self.device) for x in self.inputs[slot])
            with torch.no_grad():
                want = ref_bert.mixed_cls(w, self.cfg, ids, mask)
                got = (ref_bert.mixed_cls(w, self.cfg, ids, mask, lower=True) if lower
                       else torch.from_numpy(self.kept[slot]).to(self.device))
            worst = max(worst, compare.worst_row_gap(got, want))
        return {"cls_gap": worst}
