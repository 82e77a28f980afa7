"""Abstracts encoded, their vectors on the host, over the seconds of the
window: every call, the first one's start to the last one's end."""


def read(run):
    return run.attempted / run.window_s
