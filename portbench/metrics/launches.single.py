"""`launches.query` of the single-query cell, whose host-paced runs spread wider than
the batched cells' and so carry end-to-end metrics and bounds of their own
(`queries_per_s.single`, `query_p95_ms.single`): the same reading."""
from portbench.lib.cell import load_module

read = load_module("metrics", "launches.query").read
