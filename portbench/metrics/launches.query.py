"""Kernels launched on the card a call of the entry, from the profiler's
trace (copies and fills left out)."""

KERNELS = r"^(?!Memcpy|Memset)"


def read(run):
    if run.trace is None or run.trace.calls == 0:
        return None
    return run.trace.count(KERNELS) / run.trace.calls
