"""Milliseconds of device time a call spends reranking, from the gathered
block to the scores (`index/serve`: the queries tiled, the annealing
diameter; `ops/distances.wasserstein_dist`: the cost and marginals, the
Sinkhorn solve by K1, the plan), from the program's `rerank` spans: summed
a call, mean over the profiled calls of the fused query or the pool ranking.
The card sets the pace in these cells, so the profiler's host overhead
inside the spans is small."""
from portbench.lib.program import per_call


def read(run):
    return per_call(("fused_query", "pool_rank"), ("rerank",))
