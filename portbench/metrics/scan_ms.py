"""Milliseconds of device time a call of the fused query spends in its first
stage's scan (`index/dense.score_buckets_batched`: K7 and the top-k merge),
from the program's `scan` span: mean over the profiled calls.  The host
paces the card little here, so the profiler's overhead inside the span is
small."""
from portbench.lib.program import per_call


def read(run):
    return per_call(("fused_query",), ("scan",))
