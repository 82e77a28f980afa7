"""Profiling & tracing utilities (the port's copy of
aspire_tpu/utils/profiling.py).

The reference has no tracing at all -- only wall-clock prints
(trainer.py:291-292,336-353).  Here: torch.profiler traces of the host and
the CUDA device, viewable in TensorBoard/Perfetto, named ranges that show up
on any enclosing trace, and a lightweight host-side phase timer for pipeline
stages.
"""
from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict

import torch

log = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: str | None = None, name: str | None = None):
    """Capture a trace for the enclosed block.

    With `log_dir`: a full torch.profiler trace of the host and, when CUDA is
    available, the device, written there for TensorBoard.  Without: just a
    named range (`record_function`) so the work in the block is labelled on
    any enclosing trace.
    """
    if log_dir is not None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
            yield
    else:
        with torch.profiler.record_function(name or "aspire_block"):
            yield


class PhaseTimer:
    """Accumulating named phase timer.

    with timer("encode"): ...  -> timer.summary() dict of seconds/counts.
    Remember CUDA kernels run asynchronously: call torch.cuda.synchronize()
    inside the phase if you want device time, not launch time.
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[phase] += dt
            self.counts[phase] += 1

    def summary(self) -> dict:
        return {k: {"total_s": round(v, 6), "count": self.counts[k],
                    "mean_s": round(v / max(1, self.counts[k]), 6)}
                for k, v in self.totals.items()}

    def log_summary(self):
        for k, v in self.summary().items():
            log.info("phase %-20s total %.3fs  n=%d  mean %.4fs",
                     k, v["total_s"], v["count"], v["mean_s"])
