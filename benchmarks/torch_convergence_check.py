"""Convergence check of the PyTorch/CUDA port: BERT-base ts+otAspire
(sbalisentbienc, l2wasserstein), bf16 activations over f32 parameters, 160
optimizer steps on synthetic clustered triples -- asserts that the loss
descends, the condition of benchmarks/convergence_check.py: the least of the
last three logged losses under 0.8 x the first.

The configuration and data are that script's: B=8, T=256 tokens, 20
sentences, accumulated to 16 (two micro batches a step), Adam, lr 2e-5,
warmuplin over 40 steps; a step's triples come from np.random.default_rng(0),
query and positive on the same topics (a topic is a window of 2,000 token ids),
topics distinct within a step.  One card, so no sharding; the trainer encodes
a step's micro batches as one wide batch (fused accumulation), through the
dropout attention, its backward, hidden dropout and the Sinkhorn loop's
kernel.  Initial weights as Flax's defaults draw them (the JAX script's),
from a seeded torch.Generator: the package's own `build_model`
(`models/init.py`).

    python benchmarks/torch_convergence_check.py            # on the GPU
    python benchmarks/torch_convergence_check.py --layers 2 --steps 8 --tokens 64 --device cpu
"""
from __future__ import annotations

import argparse
import math
import sys
import tempfile
import time

import numpy as np
import torch

B, T, SMAX = 8, 256, 20
V = 30000
LOG_EVERY = 20


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=12,
                    help="encoder depth (widths stay BERT-base)")
    ap.add_argument("--steps", type=int, default=160, help="optimizer steps")
    ap.add_argument("--tokens", type=int, default=T,
                    help="tokens a document (the check's T)")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def run_config():
    from aspire_tpu_torch.core.config import RunConfig
    return RunConfig.from_dict({
        "model_name": "sbalisentbienc", "score_aggregation": "l2wasserstein",
        "sent_sm_temp": 5000.0, "sentsup_loss_prop": 1.0, "sent_loss_prop": 0.5,
        "train_size": 10000, "batch_size": B, "accumulated_batch_size": 2 * B,
        "num_epochs": 1, "learning_rate": 2e-5, "num_warmup_steps": 40,
        "lr_decay_method": "warmuplin", "es_check_every": 100000,
        "max_sents": SMAX, "update_rule": "adam", "decay_lr_every": 1})


class Triples:
    """The JAX script's synthetic data, drawn in its order from one numpy
    generator."""

    def __init__(self, seed: int = 0, tokens: int = T):
        self.rng = np.random.default_rng(seed)
        self.t = tokens

    def topic_tokens(self, topic, n):
        base = 5 + (topic * 997) % 25000
        return (base + self.rng.integers(0, 2000, n)) % V

    def feats(self, n_micro, topics):
        shape = (n_micro, B, self.t)
        tk = np.zeros(shape, np.int32)
        for m in range(n_micro):
            for b in range(B):
                tk[m, b] = self.topic_tokens(topics[m, b], self.t)
        return {
            "token_ids": tk,
            "attn_mask": np.ones(shape, np.int32),
            "sent_ids": np.clip(self.rng.integers(-1, SMAX, shape),
                                -1, SMAX - 1).astype(np.int32),
            "abs_lens": self.rng.integers(3, SMAX + 1, (n_micro, B)).astype(np.int32),
        }

    def superbatch(self):
        # distinct topics within a superbatch: in-batch negatives always come
        # from another topic, so the triplet signal is clean
        topics = self.rng.permutation(64)[: 2 * B].reshape(2, B)
        f = self.feats(2, topics)
        p = self.feats(2, topics)
        p["align"] = self.rng.integers(0, SMAX, (2, B, 2)).astype(np.int32)
        return {"query": f, "pos": p}


def train(args) -> tuple[list, float]:
    """Trains; returns the logged losses (every LOG_EVERY steps and the last
    step: the mean of the step's micro-batch losses) and the seconds of the
    steps on the host's clock."""
    from aspire_tpu_torch.core.types import require_device
    from aspire_tpu_torch.models.bert import BertConfig
    from aspire_tpu_torch.models.doc_models import build_model
    from aspire_tpu_torch.train.trainer import Trainer, tree_to_device

    dev = require_device(args.device)
    cfg = run_config()
    # build_model draws Flax's initial weights (models/init.py), seed 0
    model = build_model(cfg.model, BertConfig(num_hidden_layers=args.layers),
                        dtype=torch.bfloat16, device=dev, seed=0)
    data = Triples(0, args.tokens)
    losses_log = []
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(model, cfg, tmp, early_stop=False, fused_accum=True)
        state = tr.init_state()
        gen = torch.Generator().manual_seed(7)
        t0 = time.perf_counter()
        for step in range(args.steps):
            sb = tree_to_device(data.superbatch(), dev)
            losses = tr.train_step(state, sb, gen)
            if step % LOG_EVERY == 0 or step == args.steps - 1:
                lv = float(losses.mean())
                losses_log.append(lv)
                print(f"step {step}: loss {lv:.3f} "
                      f"({time.perf_counter() - t0:.1f}s)", flush=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        tr.close()
    return losses_log, seconds


def check_descent(losses_log: list) -> None:
    """The JAX script's condition; raises AssertionError when it fails."""
    if not all(map(math.isfinite, losses_log)):
        raise AssertionError(f"non-finite loss in {losses_log}")
    if not min(losses_log[-3:]) < losses_log[0] * 0.8:
        raise AssertionError(f"loss did not decrease: {losses_log}")


def main(argv=None) -> dict:
    args = parse_args(argv)
    print("start", flush=True)
    losses_log, seconds = train(args)
    print("trajectory:", [round(x, 2) for x in losses_log], flush=True)
    check_descent(losses_log)
    print(f"FLAGSHIP TRAINING CONVERGES ({args.steps} steps, {seconds:.1f}s)",
          flush=True)
    return {"trajectory": losses_log, "seconds": seconds, "steps": args.steps}


if __name__ == "__main__":
    main(sys.argv[1:])
