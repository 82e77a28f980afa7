"""Spans the harness records around its calls into the program's layers:
CUDA events on the card (read once the window has closed, so that nothing
waits for them inside it), the host's clock on the CPU."""
from __future__ import annotations

import contextlib
import time

import torch


class Spans:
    def __init__(self, device):
        self.on_card = device.type == "cuda"
        self.enabled = False
        self._marks: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        """Label the host's work (profiler) and, when enabled, time it."""
        with torch.profiler.record_function(f"portbench:{name}"):
            if not self.enabled:
                yield
                return
            if self.on_card:
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                a.record()
                yield
                b.record()
            else:
                a = time.perf_counter()
                yield
                b = time.perf_counter()
            self._marks.setdefault(name, []).append((a, b))

    def read(self) -> dict:
        """name -> [milliseconds a call]."""
        if self.on_card:
            torch.cuda.synchronize()
            return {k: [a.elapsed_time(b) for a, b in v] for k, v in self._marks.items()}
        return {k: [1e3 * (b - a) for a, b in v] for k, v in self._marks.items()}


class Phases(dict):
    """Seconds of each phase of a kind's set-up, for the run's log."""

    def __init__(self, device):
        super().__init__()
        self.device = device
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self[name] = now - self._t
        self._t = now
