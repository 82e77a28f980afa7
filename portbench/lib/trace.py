"""Device time from `torch.profiler` over a stretch of calls: busy seconds,
the traced window, seconds and launches by kernel name, and the idle gaps by
what the host was doing meanwhile."""
from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field


@dataclass
class Trace:
    """Device operations of a profiled stretch, times in seconds."""
    ops: list                       # (name, start, end) of each device operation
    calls: int                      # entry calls in the stretch
    gaps_by_host: dict = field(default_factory=dict)   # host activity -> idle s

    @property
    def window_s(self) -> float:
        """First device operation's start to the last one's end."""
        if not self.ops:
            return 0.0
        return max(e for _, _, e in self.ops) - min(s for _, s, _ in self.ops)

    def intervals(self) -> list:
        """The union of the operations' intervals, sorted."""
        out: list = []
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals())

    def seconds(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches `pattern`."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.ops if rx.search(n))

    def count(self, pattern: str = "") -> int:
        rx = re.compile(pattern)
        return sum(1 for n, _, _ in self.ops if rx.search(n))

    def top_ops(self, n: int = 10) -> list:
        by: dict = {}
        for name, s, e in self.ops:
            by[name] = by.get(name, 0.0) + (e - s)
        return [[k[:120], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10) -> list:
        return [[k[:120], v] for k, v in
                sorted(self.gaps_by_host.items(), key=lambda kv: -kv[1])[:n]]


def profile_calls(step, first: int, calls: int) -> Trace:
    """Run step(first) .. step(first + calls - 1) under the profiler; each
    step ends with its results on the host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(first, first + calls):
            step(i)
        torch.cuda.synchronize()
    dev, host = [], []
    for evt in prof.events():
        start, end = evt.time_range.start / 1e6, evt.time_range.end / 1e6
        if evt.device_type == DeviceType.CUDA:
            if not evt.name.startswith("portbench:"):   # the labels' own device rows
                dev.append((evt.name, start, end))
        elif end > start:
            host.append((start, end, evt.name))
    trace = Trace(ops=dev, calls=calls)
    trace.gaps_by_host = _gaps_by_host(trace.intervals(), host)
    return trace


def _gaps_by_host(busy: list, host: list) -> dict:
    """Seconds of the idle gaps between device operations, summed by what the
    host was doing at each gap's middle: the harness's phase label (a
    `record_function` named "portbench:<phase>") and the innermost other host
    event that covers it ("-" when none of the last few hundred does)."""
    labels = sorted(h for h in host if h[2].startswith("portbench:"))
    others = sorted(h for h in host if not h[2].startswith("portbench:"))
    out: dict = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        name = f"{_covering(labels, mid, len(labels))}/{_covering(others, mid, 400)}"
        out[name] = out.get(name, 0.0) + (s1 - e0)
    return out


def _covering(events: list, t: float, depth: int) -> str:
    """Name of the latest-starting event of `events` (sorted by start) that
    covers t, looking back at most `depth` events."""
    j = bisect.bisect_right(events, (t, float("inf"), "")) - 1
    for s, e, name in events[max(0, j - depth + 1): j + 1][::-1]:
        if e >= t:
            return name.removeprefix("portbench:")
    return "-"
