"""`rerank_ms` of the single-query cell: the same reading.  The host paces
this cell, so the span holds the profiler's host overhead between the
rerank's launches, and reads above the rerank's kernels' own time."""
from portbench.lib.cell import load_module

read = load_module("metrics", "rerank_ms").read
