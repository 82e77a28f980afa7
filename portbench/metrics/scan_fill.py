"""The share of the query columns K7's wide scan computed (`ops/scan_kernel`:
its live column groups x 128, summed over a call's launches) that held a
real query sentence, in %: 100 x the `sentences` count of the program's
`scan` span over its `columns` count, each a call's sum, mean over the
profiled calls.  Both are device values the program reads after the
window.  A program whose `scan` span has no such counts gives None."""
from portbench.lib.program import per_call


def read(run):
    columns = per_call(("fused_query",), ("scan",), count="columns")
    sentences = per_call(("fused_query",), ("scan",), count="sentences")
    if not columns or sentences is None:
        return None
    return 100.0 * sentences / columns
