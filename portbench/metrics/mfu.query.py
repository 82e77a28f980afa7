"""The whole query step's share of the card's peak: the least time of the
work the profiled calls needed (the encoder's products, the scan, the
rerank's cost products and Sinkhorn terms; lib/work) over the traced
window, in %."""
from portbench.lib.work import encoder_seconds, rerank_seconds, scan_seconds


def need(w: dict) -> float:
    return ((encoder_seconds(w["encoder"]) if "encoder" in w else 0.0)
            + (scan_seconds(w["scan"]) if "scan" in w else 0.0)
            + (rerank_seconds(w["rerank"]) if "rerank" in w else 0.0))


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * sum(need(w) for w in run.work) / run.trace.window_s
