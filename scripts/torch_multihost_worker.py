"""One process of a several-machine data-parallel training job of the port,
for execution testing (counterpart of scripts/multihost_worker.py).

The reference scales training with torch DDP: one process per GPU, NCCL
process groups (main_fsim.py:36-46), per-rank pre-split data files
(run_main_fsim-ddp.sh:51-90).  The port keeps one process a rank but not the
split files: every process joins the group through
`parallel.mesh.initialize_multihost`, builds the same data mesh, streams the
SAME superbatches, and the Trainer gives each rank its rows
(`shard_batch`) and sums the gradients over the ranks.

N processes train a tiny model in lockstep through the real Trainer
(early-stop dev scoring, rank-0 checkpoints and metrics in the shared run
directory), then each dumps its final parameters and its loss and dev-score
histories for the cross-process and against-one-process checks of
tests/test_torch_multihost.py.

Usage (one invocation per process, same --out for all):
  python scripts/torch_multihost_worker.py --coordinator 127.0.0.1:PORT \\
      --num-processes 2 --process-id 0 --out /tmp/dp [--device cpu]
--coordinator also takes a file:// init method (a path every process sees).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def make_superbatch(rng, n_micro=2, b=8, t=16, smax=4):
    """Deterministic tiny superbatch (identical on every process)."""
    import numpy as np

    def feats():
        return {
            "token_ids": rng.integers(5, 128, (n_micro, b, t)).astype(np.int32),
            "attn_mask": np.ones((n_micro, b, t), np.int32),
            "sent_ids": np.clip(rng.integers(-1, smax, (n_micro, b, t)), -1,
                                smax - 1).astype(np.int32),
            "abs_lens": rng.integers(1, smax + 1, (n_micro, b)).astype(np.int32),
        }
    return {"query": feats(), "pos": feats()}


def _long(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _long(v) for k, v in tree.items()}
    return torch.from_numpy(tree).long()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--out", required=True,
                    help="SHARED output dir (all processes)")
    ap.add_argument("--n-batches", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="'cpu' runs gloo ranks on the CPU")
    args = ap.parse_args()

    import numpy as np
    import torch

    from aspire_tpu_torch.core.config import RunConfig
    from aspire_tpu_torch.models.bert import BertConfig
    from aspire_tpu_torch.models.doc_models import build_model
    from aspire_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
    from aspire_tpu_torch.train.trainer import Trainer

    mesh, device = None, args.device
    if args.num_processes > 1:
        device = initialize_multihost(args.coordinator, args.num_processes,
                                      args.process_id, device=args.device)
        mesh = make_mesh()

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    cfg = RunConfig.from_dict({
        "model_name": "miswordbienc", "score_aggregation": "l2max",
        "train_size": 48, "batch_size": 8, "accumulated_batch_size": 16,
        "num_epochs": 1, "learning_rate": 1e-4, "num_warmup_steps": 2,
        "lr_decay_method": "warmuplin", "es_check_every": 4,
        "max_sents": 4, "update_rule": "adam", "decay_lr_every": 1})
    torch.manual_seed(0)
    model = build_model(cfg.model, BertConfig.tiny(), device=device)

    rng = np.random.default_rng(0)
    batches = [_long(make_superbatch(rng)) for _ in range(args.n_batches)]
    # dev batches are flat [batch, ...] trees with explicit negatives
    dev_rng = np.random.default_rng(1)
    dev = [make_superbatch(dev_rng, n_micro=1) for _ in range(2)]
    dev_flat = _long({"query": dev[0]["query"], "pos": dev[0]["pos"],
                      "neg": dev[1]["pos"]})
    dev_flat = {k: {f: a[0] for f, a in v.items()} for k, v in dev_flat.items()}

    trainer = Trainer(model, cfg, str(out / "run"), mesh=mesh)
    state = trainer.init_state()
    state = trainer.train(state, batches,
                          dev_batches_fn=lambda: iter([dev_flat]), seed=7)

    np.savez(out / f"params-proc{args.process_id}.npz",
             **{k: v.detach().cpu().numpy()
                for k, v in state.model.state_dict().items()})
    (out / f"summary-proc{args.process_id}.json").write_text(json.dumps({
        "process_count": args.num_processes,
        "world_size": 1 if mesh is None else mesh.world_size,
        "device": str(device),
        "losses": [float(x) for x in trainer.loss_history],
        "dev_scores": [float(x) for x in trainer.dev_score_history],
        "best_score": float(trainer.best_score),
    }))
    print(f"[proc {args.process_id}] done: {args.num_processes} processes",
          flush=True)
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
