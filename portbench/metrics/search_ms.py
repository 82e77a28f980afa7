"""Milliseconds of device time a call spends in the fused query
(`index.serve.make_fused_query_batched` / `make_fused_query`: scan, gather,
rerank): CUDA events around the call, mean over the window's calls after the
profiled stretch."""


def read(run):
    ms = run.spans.get("search")
    return sum(ms) / len(ms) if ms else None
