"""Process start to the first timed call: imports, loading the kernel
library (building it, in a checkout's first run), weights and data made on
the card, warm-up of the cell's own shapes."""


def read(run):
    return run.setup_s
