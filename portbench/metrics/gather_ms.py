"""Milliseconds of device time a call spends gathering its candidates' rows
from the index (`index/serve._gather_candidates`; the pool path gathers once
a chunk of queries), from the program's `gather` spans: summed a call, mean
over the profiled calls of the fused query or the pool ranking.  The card
sets the pace in these cells, so the profiler's host overhead inside the
spans is small."""
from portbench.lib.program import per_call


def read(run):
    return per_call(("fused_query", "pool_rank"), ("gather",))
