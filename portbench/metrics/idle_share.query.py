"""Share of the traced window (first device operation's start to the last
one's end) in which no operation ran on the card, in %."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
