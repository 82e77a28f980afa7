"""K7, the int8 l2max scan (`ops/scan_kernel.py`; `csrc/scan.cu`,
`csrc/scan_int8.cu`): the least time of the scans the profiled calls made
(lib/work.scan_seconds: the rows' bytes, or the real query sentences'
products with the real document sentences on the bf16 tensor cores) over the
scan kernels' device time, in %."""
from portbench.lib.work import scan_seconds

KERNELS = r"(?<![A-Za-z_])scan_(wide_)?kernel"


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.seconds(KERNELS)
    need = sum(scan_seconds(w["scan"]) for w in run.work if "scan" in w)
    return 100.0 * need / spent if spent > 0 and need > 0 else None
