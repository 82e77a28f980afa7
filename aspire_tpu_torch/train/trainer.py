"""Trainer: eager train step + host-side control loop, on one device or as
one rank of a data mesh (counterpart of aspire_tpu/train/trainer.py, itself a
re-design of src/learning/trainer.py GenericTrainer/BasicRankingTrainer,
:95-803).

  * Gradient accumulation (batch 3 -> effective 30 in the reference,
    trainer.py:139-153) runs over a [n_micro, micro, ...] superbatch inside
    one step: either one wide encode of all n_micro * micro examples
    (`fused_accum`, model.train_loss_grouped) or a loop of micro batches whose
    `backward()` calls sum into the gradients, with a single optimizer update
    at the end either way.
  * The schedule is a function of the micro-iteration count (schedules.py);
    `LambdaLR` reads it at (updates taken) * update_every, so the first update
    runs at schedule(0) as optax's does.
  * A non-finite summed loss suppresses the update: parameters, optimizer
    moments, schedule and step count stay as they were.  That costs one host
    read of a scalar per optimizer step, before `optimizer.step()`.
  * Early stopping keeps the reference protocol: every `es_check_every` micro
    iterations evaluate summed dev loss (explicit frozen negatives), track
    `-loss` as the dev score, checkpoint `cur_best` on improvement and
    `final` at the end (trainer.py:222-246,305-346).
  * Checkpoints are `model_{suffix}.pt` (a state_dict, the reference's own
    contract) + the `run_info.json` contract (main_fsim.py:84-86); the full
    training state goes to `state_{suffix}.pt`.  The JAX package writes orbax
    trees instead; models/convert.py bridges the two over numpy trees.

Data parallel (`mesh=`, a parallel.mesh.Mesh with a "data" axis; one process
a rank, every rank streaming the same superbatches): the parameters start as
rank 0's (`replicate`); the sequential path gives each rank its share of every
micro batch (`shard_batch(axis=1)`), the fused path its contiguous run of the
window's rows laid end to end; the model's loss on a rank is that rank's share
of the one-process loss (models/doc_models.py), so the gradients are SUMMED
over the ranks -- one all_reduce an optimizer step, after the accumulation --
not averaged.  The micro losses are summed over the ranks before the
non-finite check, so every rank takes or skips the same update; dev losses
are summed likewise.  Rank 0 alone writes metrics, checkpoints and
run_info.json; the other ranks wait for it at a barrier.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import math
import pathlib
import time
from typing import Callable, Iterator

import torch
import torch.distributed as dist

from ..core.config import RunConfig
from ..parallel.mesh import all_reduce, replicate, shard_batch
from .schedules import build_schedule

log = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0              # number of optimizer updates taken


def tree_to_device(tree, device):
    """A nested dict of arrays or tensors as tensors on `device`."""
    if isinstance(tree, dict):
        return {k: tree_to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device, non_blocking=True)


def _micro(tree, i: int):
    if isinstance(tree, dict):
        return {k: _micro(v, i) for k, v in tree.items()}
    return tree[i]


def _flatten_micro(tree):
    """[n_micro, micro, ...] leaves -> [n_micro * micro, ...]."""
    if isinstance(tree, dict):
        return {k: _flatten_micro(v) for k, v in tree.items()}
    return tree.reshape((-1,) + tuple(tree.shape[2:]))


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


class Trainer:
    """Drives training of a doc_models.* / sent_models.* model on its device.

    model: nn.Module exposing `train_loss(batch, rng, train)` (and
        `train_loss_grouped` for `fused_accum`), see models/doc_models.py.
    batches: iterator of superbatches -- nested dicts whose arrays are
        [n_micro, micro_batch, ...]; tensors or numpy arrays, moved to the
        model's device here.
    dev_batches_fn: callable returning an iterator of dev batches (with
        explicit negatives) for each early-stop check.
    """

    def __init__(self, model, run_config: RunConfig, model_path: str,
                 early_stop: bool = True, fused_accum: bool = False,
                 mesh=None):
        self.model = model
        self.cfg = run_config
        tp = run_config.train
        self.tp = tp
        self.mesh = mesh
        if mesh is not None and tp.batch_size % mesh.size("data"):
            raise ValueError(f"micro batch {tp.batch_size} does not split "
                             f"over {mesh.size('data')} data ranks")
        self.model_path = pathlib.Path(model_path)
        self.model_path.mkdir(parents=True, exist_ok=True)
        self.early_stop = early_stop
        # fused_accum: encode the whole [n_micro, micro] superbatch as ONE
        # wide batch instead of a sequential loop -- the same summed gradient
        # (model.train_loss_grouped), far larger products per launch at the
        # reference's tiny micro batches.
        self.fused_accum = bool(fused_accum) and hasattr(model, "train_loss_grouped")
        if fused_accum and not self.fused_accum:
            log.warning("fused_accum requested but %s has no "
                        "train_loss_grouped; using the sequential path",
                        type(model).__name__)

        self.update_every = 1
        if tp.accumulated_batch_size and tp.accumulated_batch_size > 0:
            if tp.accumulated_batch_size % tp.batch_size:
                raise ValueError("accumulated_batch_size must be a multiple "
                                 "of batch_size")
            self.update_every = tp.accumulated_batch_size // tp.batch_size
        if tp.update_rule not in ("adam", "adagrad"):
            raise ValueError(f"Unknown update rule: {tp.update_rule}")
        self._schedule = build_schedule(tp)

        self.loss_history: list[float] = []
        self.loss_checked_iters: list[int] = []
        self.dev_score_history: list[float] = []
        self.dev_checked_iters: list[int] = []
        # global-best dev score across ALL epochs and train() calls, so
        # `model_cur_best` is the run-wide best exactly like the reference's
        # single best tracked over the whole run (trainer.py:222-246) -- a
        # worse later epoch must never overwrite it
        self.best_score = -math.inf
        self._micro_iter = 0
        self.time_per_batch = 0.0
        # jsonl metrics stream, opened lazily on first write and closed by
        # train()/close()
        self._metrics_file = None

    @property
    def is_writer(self) -> bool:
        """Rank 0 of a mesh, or the one process: the one that writes files."""
        return self.mesh is None or self.mesh.rank == 0

    def _barrier(self) -> None:
        if self.mesh is not None:
            dist.barrier()

    def log_metric(self, **kv) -> None:
        if not self.is_writer:
            return
        if self._metrics_file is None or self._metrics_file.closed:
            self._metrics_file = open(self.model_path / "metrics.jsonl", "a")
        self._metrics_file.write(json.dumps(kv) + "\n")
        self._metrics_file.flush()

    def close(self) -> None:
        """Release the metrics.jsonl handle (idempotent)."""
        if self._metrics_file is not None and not self._metrics_file.closed:
            self._metrics_file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def micro_schedule(self, count: int) -> float:
        """optimizer update count -> lr (reference schedules tick per micro
        iteration, trainer.py:289-291)."""
        return self._schedule(count * self.update_every)

    def init_state(self) -> TrainState:
        """Optimizer and scheduler over the model's parameters (rank 0's on
        every rank of a mesh).  The base lr is 1 so that LambdaLR's factor is
        the learning rate itself."""
        if self.mesh is not None:
            replicate(self.model, self.mesh)
        params = [p for p in self.model.parameters() if p.requires_grad]
        if self.tp.update_rule == "adam":
            optimizer = torch.optim.Adam(params, lr=1.0)
        else:
            # optax.adagrad's defaults, which differ from torch's (0, 1e-10)
            optimizer = torch.optim.Adagrad(
                params, lr=1.0, initial_accumulator_value=0.1, eps=1e-7)
        scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer,
                                                      self.micro_schedule)
        return TrainState(self.model, optimizer, scheduler, 0)

    def place(self, superbatch):
        """A host superbatch [n_micro, micro, ...] as train_step takes it: on
        the model's device, or this rank's share of it on a mesh (the fused
        path's: a contiguous run of the window's rows laid end to end)."""
        if self.mesh is None:
            return tree_to_device(superbatch, self.device)
        if self.fused_accum:
            return shard_batch(_flatten_micro(superbatch), self.mesh)
        return shard_batch(superbatch, self.mesh, axis=1)

    def train_step(self, state: TrainState, superbatch,
                   rng: torch.Generator | None,
                   n_micro: int | None = None) -> torch.Tensor:
        """One optimizer step over a superbatch (from `place`).  Returns the
        micro batches' losses -- on a mesh summed over the ranks -- detached,
        f32[n_micro].  n_micro: the window's micro batches, needed on a mesh
        with fused_accum (the rows arrive laid end to end)."""
        model = state.model
        mesh = {} if self.mesh is None else {"mesh": self.mesh}
        state.optimizer.zero_grad(set_to_none=True)
        if self.fused_accum:
            if self.mesh is not None:
                mesh["n_micro"] = n_micro
            loss_sum, losses = model.train_loss_grouped(superbatch, rng, True,
                                                        **mesh)
            loss_sum.backward()
            losses = losses.detach()
        else:
            losses = []
            for i in range(_first_leaf(superbatch).shape[0]):
                loss = model.train_loss(_micro(superbatch, i), rng, True,
                                        **mesh)
                loss.backward()               # gradients sum over micro batches
                losses.append(loss.detach())
            losses = torch.stack(losses)
        if self.mesh is not None:
            self._sum_grads(state.optimizer)
            losses = all_reduce(losses, self.mesh)
        # failure detection: suppress the update when the summed loss is
        # non-finite (a guard the reference lacks).  Zeroed gradients alone
        # would not do: Adam would still take a momentum-only step.
        if bool(torch.isfinite(losses.sum())):
            state.optimizer.step()
            state.scheduler.step()
            state.step += 1
        state.optimizer.zero_grad(set_to_none=True)
        return losses.float()

    def _sum_grads(self, optimizer) -> None:
        """The gradients summed over the data ranks: one all_reduce of all of
        them laid end to end."""
        grads = [p.grad for group in optimizer.param_groups
                 for p in group["params"] if p.grad is not None]
        flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), self.mesh)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    # ------------------------------------------------------------------
    def dev_score(self, state: TrainState, dev_batches: Iterator) -> float:
        """-sum(dev loss) over the dev stream (over every rank's rows on a
        mesh); summed on the device and read once."""
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        mesh = {} if self.mesh is None else {"mesh": self.mesh}
        with torch.no_grad():
            for batch in dev_batches:
                batch = (tree_to_device(batch, self.device) if self.mesh is None
                         else shard_batch(batch, self.mesh))
                total += state.model.train_loss(batch, None, False,
                                                **mesh).float()
        if self.mesh is not None:
            total = all_reduce(total, self.mesh)
        return -float(total)

    def train(self, state: TrainState, batches,
              dev_batches_fn: Callable[[], Iterator] | None = None,
              seed: int = 0, epochs: int = 1) -> TrainState:
        """Run `epochs` passes over `batches` (re-iterated per epoch).  The
        best dev score is tracked across epochs and repeated train() calls
        (self.best_score), matching the reference's run-wide
        `model_cur_best` (trainer.py:222-246)."""
        if epochs > 1 and iter(batches) is batches:
            raise ValueError(
                "epochs > 1 needs a re-iterable `batches`: a plain iterator "
                "is exhausted after epoch 1 and the rest would silently train "
                "on nothing")
        rng = torch.Generator().manual_seed(seed)
        t_start = time.time()
        try:
            state = self._train_epochs(state, batches, dev_batches_fn, rng,
                                       epochs, t_start)
        finally:
            self.close()
        return state

    def _train_epochs(self, state, batches, dev_batches_fn, rng, epochs,
                      t_start):
        tp = self.tp
        n_steps = 0
        for epoch in range(epochs):
            if epochs > 1:
                log.info("epoch %d/%d", epoch + 1, epochs)
            for superbatch in iter(batches):
                mesh = {} if self.mesh is None else {
                    "n_micro": _first_leaf(superbatch).shape[0]}
                losses = self.train_step(state, self.place(superbatch), rng,
                                         **mesh)
                n_micro = int(losses.shape[0])
                n_steps += 1
                prev_iter = self._micro_iter
                self._micro_iter += n_micro
                micro_iter = self._micro_iter
                if n_steps % 5 == 0 or n_steps == 1:
                    # one pull of the losses per 5 steps, for the history and
                    # the operator-facing warning
                    self._record_losses(losses, n_steps, prev_iter, micro_iter)
                if (self.early_stop and dev_batches_fn is not None
                        and micro_iter // tp.es_check_every > prev_iter // tp.es_check_every):
                    score = self.dev_score(state, dev_batches_fn())
                    self.dev_score_history.append(score)
                    self.dev_checked_iters.append(micro_iter)
                    self.log_metric(kind="dev_score", iter=micro_iter, score=score)
                    if score > self.best_score:
                        self.best_score = score
                        self.save_checkpoint(state, "cur_best")
                        log.info("iter %d new best dev score %.4f", micro_iter, score)
                    else:
                        log.info("iter %d dev score %.4f", micro_iter, score)
        self.time_per_batch = (time.time() - t_start) / max(1, n_steps)
        self.save_checkpoint(state, "final")
        if self.best_score == -math.inf:
            # no dev checks ran; final is also the best
            self.save_checkpoint(state, "cur_best")
        self.plot_history()
        return state

    def _record_losses(self, losses, n_steps, prev_iter, micro_iter) -> None:
        tp = self.tp
        lvals = losses.cpu().tolist()
        if not all(math.isfinite(x) for x in lvals):
            log.warning("non-finite loss %s at step %d; the update was "
                        "suppressed", lvals, n_steps)
        self.loss_history.extend(lvals)
        self.loss_checked_iters.extend(range(prev_iter, micro_iter))
        mean = sum(lvals) / len(lvals)
        log.info("iter %d/%d loss %.4f", micro_iter,
                 tp.num_epochs * max(1, tp.train_size // max(1, tp.batch_size)),
                 mean)
        self.log_metric(kind="train_loss", iter=micro_iter, loss=mean)

    # ------------------------------------------------------------------
    def save_checkpoint(self, state: TrainState, suffix: str) -> None:
        """model_{suffix}.pt (state_dict on the CPU) + run_info.json, written
        by rank 0 while the other ranks wait."""
        if self.is_writer:
            sd = {k: v.detach().cpu()
                  for k, v in state.model.state_dict().items()}
            torch.save(sd, self.model_path / f"model_{suffix}.pt")
            self.cfg.to_run_info(self.model_path / "run_info.json")
        self._barrier()

    def load_checkpoint(self, suffix: str) -> dict:
        from ..utils.checkpoint import restore_params
        return restore_params(self.model_path / f"model_{suffix}.pt")

    def save_full_state(self, state: TrainState, suffix: str = "resume") -> None:
        """Full training state (model + optimizer + scheduler + step + best
        score) for resume -- capability the reference lacks.  Rank 0 writes
        it; every rank restores it (`restore_full_state`)."""
        if self.is_writer:
            torch.save({"model": state.model.state_dict(),
                        "optimizer": state.optimizer.state_dict(),
                        "scheduler": state.scheduler.state_dict(),
                        "step": state.step, "micro_iter": self._micro_iter,
                        "best_score": self.best_score},
                       self.model_path / f"state_{suffix}.pt")
            self.cfg.to_run_info(self.model_path / "run_info.json")
        self._barrier()

    def restore_full_state(self, suffix: str = "resume") -> TrainState:
        """Load a saved training state into this trainer's model and a fresh
        optimizer and scheduler."""
        raw = torch.load(self.model_path / f"state_{suffix}.pt",
                         map_location=self.device, weights_only=True)
        state = self.init_state()
        state.model.load_state_dict(raw["model"])
        state.optimizer.load_state_dict(raw["optimizer"])
        state.scheduler.load_state_dict(raw["scheduler"])
        state.step = int(raw["step"])
        self._micro_iter = int(raw["micro_iter"])
        self.best_score = float(raw["best_score"])
        return state

    def plot_history(self) -> None:
        """Loss/dev-score curves (reference data_utils.plot_train_hist)."""
        if not self.is_writer:
            return
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:  # pragma: no cover
            return
        if self.loss_history:
            fig, ax = plt.subplots()
            ax.plot(self.loss_checked_iters, self.loss_history)
            ax.set_xlabel("iteration"); ax.set_ylabel("loss")
            fig.savefig(self.model_path / "train_loss.png"); plt.close(fig)
        if self.dev_score_history:
            fig, ax = plt.subplots()
            ax.plot(self.dev_checked_iters, self.dev_score_history)
            ax.set_xlabel("iteration"); ax.set_ylabel("dev score")
            fig.savefig(self.model_path / "dev_score.png"); plt.close(fig)
