"""K1, the Sinkhorn solve (`ops/sinkhorn_kernel.py`, `csrc/sinkhorn.cu`): the
least time of the solves the profiled calls made (lib/work.sinkhorn_seconds:
two exponentials a cell and a log an atom a round over the real atoms, on the
special-function units, or the bytes of cost, weights and potentials) over
the solver kernels' device time, in %."""
from portbench.lib.work import sinkhorn_seconds

KERNELS = r"sinkhorn_(small|wide|cluster)_kernel"


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.seconds(KERNELS)
    need = sum(sinkhorn_seconds(w["rerank"]) for w in run.work if "rerank" in w)
    return 100.0 * need / spent if spent > 0 and need > 0 else None
