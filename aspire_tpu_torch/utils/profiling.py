"""Spans of the port's serving layers, and the operator's trace exporter.

A span marks one stage of an entry call, where the stage runs:

    fused_query > scan, merge (several ranks), gather, rerank, scores
    pool_rank   > gather, rerank, scores        (a gather and a rerank a chunk)
    rerank      > diameter (> reduce on several ranks), cost, solve
    scores      > reduce (several ranks)
    encode      > bert.embed, bert.layer (one name for all), pool or cls_mix

with counts `queries` (the roots), `bytes` (gather: the index rows and
scales indexed; reduce: the all_reduce's), `pairs` (rerank), `tokens`
(encode, padded), and on `scan` `columns` and `sentences` (the query columns
the wide int8 and bf16 scans computed and the real query sentences they
scored: device values, ops/scan_kernel).

Tracing is off unless `recording()` is active or a `torch.profiler` is
collecting.  Off, `span` checks this module's flag and the profiler's and
returns one shared no-op: no torch call, no allocation, no synchronise.
On, a span

  * labels its interval `aspire:<name>` on the profiler's host timeline, as a
    FUNCTION-scope record function (`_RecordFunctionFast`): a host event
    with no device row, where a USER_SCOPE `record_function` also comes back
    from kineto as a `gpu_user_annotation` on the device's timeline;
  * records its host start and end (`time.perf_counter_ns`), a pair of CUDA
    timing events on the current stream once CUDA is initialised, the id of
    its parent span, the id of its root span (its `call`: the spans of one
    entry call share it), and its counts: host integers taken from shapes
    and dtypes, and those `count()` adds to the innermost open span, which
    may be 0-dim device tensors, kept as they are and read only by
    `records()`.

Records stay in memory, the newest MAX_RECORDS of them; nothing is written
while they are made.  `records()` synchronises once and reads them,
`summary()` sums them by name with each name's self time, `reset()` clears
them.  `trace(log_dir)` writes a `torch.profiler` trace of a block for
TensorBoard or Perfetto, the spans' labels in it.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

MAX_RECORDS = 1 << 16

_recording = 0                    # depth of the active recording() blocks
_records: deque = deque(maxlen=MAX_RECORDS)
_ids = itertools.count(1)
_local = threading.local()        # .stack: this thread's open spans


class _NoSpan:
    """The span when tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoSpan()


_streams: dict = {}


def _current_stream():
    """torch.cuda.current_stream(), one Stream object kept for each stream:
    building it anew costs more than a timing event's record."""
    key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.Stream(
            stream_id=key[0], device_index=key[1], device_type=key[2])
    return stream


class _Span:
    __slots__ = ("name", "id", "call", "parent", "counts", "added", "t0", "t1",
                 "ev0", "ev1", "device_ms", "_label", "_stream")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts
        self.added = []                   # count()'s (name, value), unread
        self.device_ms = None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.call = parent.call if parent is not None else self.id
        self._label = _RecordFunctionFast(f"aspire:{self.name}")
        self._label.__enter__()
        self.t0 = time.perf_counter_ns()
        if torch.cuda.is_initialized():
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self._stream = _current_stream()
            self.ev0.record(self._stream)
        else:
            self.ev0 = self.ev1 = self._stream = None
        stack.append(self)
        return self

    def __exit__(self, *exc):
        if self.ev1 is not None:
            self.ev1.record(self._stream)
        self.t1 = time.perf_counter_ns()
        _local.stack.pop()
        self._label.__exit__(*exc)
        self._label = self._stream = None
        _records.append(self)
        return False


def tracing() -> bool:
    """Whether spans record: inside `recording()` or while a profiler collects."""
    return bool(_recording or _autograd_profiler._is_profiler_enabled)


def span(name: str, **counts):
    """Context manager marking one stage (see the module's docstring);
    counts: host integers from shapes and dtypes."""
    if not tracing():
        return _NOOP
    return _Span(name, counts)


def count(**counts) -> None:
    """Add counts to the innermost open span of this thread: host integers
    or 0-dim tensors, a device value read only when `records()` is.
    Nothing with tracing off or outside every span."""
    stack = getattr(_local, "stack", None)
    if stack and tracing():
        stack[-1].added.extend(counts.items())


@contextlib.contextmanager
def recording():
    """Tracing on for the block, with no profiler: the stage times alone."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def reset() -> None:
    """Forget every record."""
    _records.clear()


def records() -> list[dict]:
    """The records kept, oldest first: name, id, call (the root span's id),
    parent (None at a root), host_ms, device_ms (None off the card) and
    counts.  Synchronises once when a record's device time is unread, and
    reads the counts `count()` added."""
    spans = list(_records)
    pending = [s for s in spans if s.ev0 is not None]
    if pending:
        torch.cuda.synchronize()
        for s in pending:
            s.device_ms = s.ev0.elapsed_time(s.ev1)
            s.ev0 = s.ev1 = None
    for s in spans:
        for name, value in s.added:
            s.counts[name] = s.counts.get(name, 0) + int(value)
        s.added = []
    return [{"name": s.name, "id": s.id, "call": s.call, "parent": s.parent,
             "host_ms": (s.t1 - s.t0) / 1e6, "device_ms": s.device_ms,
             "counts": dict(s.counts)} for s in spans]


def summary() -> dict:
    """name -> {count, host_ms, host_self_ms, device_ms, device_self_ms}:
    totals over the records, a span's self time being its duration less
    that of its children (device times None where a record has none)."""
    recs = records()
    children: dict = {}
    for r in recs:
        if r["parent"] is not None:
            children.setdefault(r["parent"], []).append(r)
    out: dict = {}
    for r in recs:
        kids = children.get(r["id"], [])
        s = out.setdefault(r["name"], {"count": 0, "host_ms": 0.0, "host_self_ms": 0.0,
                                       "device_ms": 0.0, "device_self_ms": 0.0})
        s["count"] += 1
        s["host_ms"] += r["host_ms"]
        s["host_self_ms"] += r["host_ms"] - sum(k["host_ms"] for k in kids)
        dev = [r["device_ms"]] + [k["device_ms"] for k in kids]
        if s["device_ms"] is None or None in dev:
            s["device_ms"] = s["device_self_ms"] = None
        else:
            s["device_ms"] += dev[0]
            s["device_self_ms"] += dev[0] - sum(dev[1:])
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Write a `torch.profiler` trace of the block's host work and, when CUDA
    is available, the device's to `log_dir` (TensorBoard's profile plugin or
    Perfetto read it).  The program's spans are on inside it: each stage is
    labelled `aspire:<name>` on the host's timeline and recorded."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
