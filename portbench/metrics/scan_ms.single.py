"""`scan_ms` of the single-query cell (the narrow K7): the same reading.
The host paces this cell, so the span holds the profiler's host overhead
wherever the scan waits for a launch."""
from portbench.lib.cell import load_module

read = load_module("metrics", "scan_ms").read
