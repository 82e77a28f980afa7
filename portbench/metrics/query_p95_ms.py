"""95th percentile of every query's latency in the window: from its call's
start (inputs handed to the entry) to its results on the host; every query
of a call has its call's latency."""


def read(run):
    return run.percentile_ms(95)
