"""The program's own spans (`aspire_tpu_torch.utils.profiling`), read for
the per-layer metrics of a `--trace 1` run.

The program records its spans while a `torch.profiler` collects, so a traced
run records exactly the harness's profiled stretch (`trace_calls` calls):
the warm-up, the window after the stretch and the check record nothing.
Each span's device time is CUDA events on the stream around its work, so it
holds the profiler's host overhead wherever the host paces the card.  A
program without spans (no `records()`), a CPU run (no device times) or
`--trace 0` gives None."""
from __future__ import annotations


def records() -> list:
    from aspire_tpu_torch.utils import profiling
    read = getattr(profiling, "records", None)
    return read() if read is not None else []


def per_call(roots: tuple, names: tuple, count: str | None = None):
    """Mean over the root calls recorded (spans named in `roots` with no
    parent) of the sum, over each call's spans named in `names`, of their
    device ms, or of their count `count`.  None where no root was recorded
    on the card or no such span was."""
    recs = records()
    calls = {r["id"]: 0.0 for r in recs if r["parent"] is None
             and r["name"] in roots and r["device_ms"] is not None}
    found = False
    for r in recs:
        if r["call"] in calls and r["name"] in names:
            value = r["device_ms"] if count is None else r["counts"].get(count)
            if value is None:
                return None
            calls[r["call"]] += value
            found = True
    return sum(calls.values()) / len(calls) if found else None
