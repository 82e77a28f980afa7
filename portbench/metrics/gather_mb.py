"""Megabytes (10^6 bytes) of index rows and scales a call's gathers index
(`index/serve._gather_candidates`), from the `bytes` count of the program's
`gather` spans (the candidates times each bucket's sentences, cut at
max_sents, times a sentence's bytes and scale): summed a call, mean over the
profiled calls.  A count from shapes: it repeats exactly."""
from portbench.lib.program import per_call


def read(run):
    n = per_call(("fused_query", "pool_rank"), ("gather",), count="bytes")
    return None if n is None else n / 1e6
