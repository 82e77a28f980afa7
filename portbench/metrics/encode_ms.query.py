"""Milliseconds of device time a call spends in the query encoder
(`ConSentEncoder`): CUDA events around the encoder call, mean over the
window's calls after the profiled stretch."""


def read(run):
    ms = run.spans.get("encode")
    return sum(ms) / len(ms) if ms else None
