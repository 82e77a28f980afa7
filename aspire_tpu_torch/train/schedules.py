"""Learning-rate schedules matching the reference trainer semantics
(counterpart of aspire_tpu/train/schedules.py).

The reference steps its scheduler once every `decay_lr_every` *micro*
iterations (trainer.py:289-291) while the optimizer steps every
`accumulated_batch_size/batch_size` micro iterations, and sizes warmup/total
in micro-iteration units (trainer.py:196-207).  `build_schedule` therefore
returns a plain function of the *micro-iteration count*; the trainer converts
its update count to micro iterations before the lookup and feeds the ratio to
`torch.optim.lr_scheduler.LambdaLR`.
"""
from __future__ import annotations

import math

from ..core.config import TrainHParams


def total_micro_iters(tp: TrainHParams) -> int:
    num_batches = max(1, -(-tp.train_size // tp.batch_size))
    return tp.num_epochs * num_batches


def _linear(start: float, end: float, steps: int, count: float) -> float:
    frac = min(max(count, 0.0), steps) / steps
    return start + (end - start) * frac


def build_schedule(tp: TrainHParams):
    """-> callable(micro_iter) -> lr, mirroring trainer.py:188-207."""
    total = total_micro_iters(tp)
    peak = float(tp.learning_rate)
    if tp.lr_decay_method == "warmuplin":
        # transformers get_linear_schedule_with_warmup: linear 0 -> peak over
        # warmup steps, then linear peak -> 0 at `total`.
        warmup = max(1, tp.num_warmup_steps)
        decay = max(total, warmup + 1)

        def warmuplin(count):
            if count < warmup:
                return _linear(0.0, peak, warmup, count)
            return _linear(peak, 0.0, decay - warmup, count - warmup)
        return warmuplin
    if tp.lr_decay_method == "warmupcosine":
        warmup = max(1, tp.num_warmup_steps)
        decay = max(total, tp.num_warmup_steps + 1)

        def warmupcosine(count):
            if count < warmup:
                return _linear(0.0, peak, warmup, count)
            frac = min(max(count - warmup, 0), decay - warmup) / (decay - warmup)
            return peak * 0.5 * (1.0 + math.cos(math.pi * frac))
        return warmupcosine
    if tp.lr_decay_method == "exponential":
        # reference: ExponentialLR stepped every decay_lr_every micro iters
        every = max(1, tp.decay_lr_every)
        return lambda count: peak * tp.decay_lr_by ** (count // every)
    raise ValueError(f"Unknown lr_decay_method: {tp.lr_decay_method}")
