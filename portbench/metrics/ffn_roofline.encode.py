"""K3, the FFN (`ops/ffn_kernel.py`, `csrc/ffn.cu`) in the corpus encode:
the least time of every layer's FFN (the real tokens' products on the bf16
tensor cores, or the bytes of x, both weights and out) over the FFN kernel's
device time, in %."""
from portbench.lib.peaks import PEAK_BF16, least_seconds
from portbench.lib.work import ffn_bytes, ffn_ops

KERNELS = r"ffn_bf16_kernel"


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.seconds(KERNELS)
    need = sum(w["encoder"]["layers"] * least_seconds(
        ffn_bytes(w["encoder"]), ffn_ops(w["encoder"]), PEAK_BF16)
        for w in run.work if "encoder" in w)
    return 100.0 * need / spent if spent > 0 and need > 0 else None
