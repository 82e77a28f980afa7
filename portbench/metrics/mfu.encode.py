"""The whole encode step's share of the card's peak: the least time of the
encoder's products over the real tokens of the profiled calls (bf16 tensor
cores; lib/work.encoder_seconds) over the traced window, in %."""
from portbench.lib.work import encoder_seconds


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    need = sum(encoder_seconds(w["encoder"]) for w in run.work if "encoder" in w)
    return 100.0 * need / run.trace.window_s
