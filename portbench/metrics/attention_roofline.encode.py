"""K2, the attention forward (`ops/attention_kernel.py`, `csrc/attention.cu`)
in the corpus encode: the least time of every layer's attention (q.k and p.v
over each document's real tokens on the bf16 tensor cores, or the bytes of
q, k, v, the context and the key mask) over the kernel's device time, in %."""
from portbench.lib.peaks import PEAK_BF16, least_seconds
from portbench.lib.work import attention_bytes, attention_ops

KERNELS = r"attention_bf16_kernel"


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.seconds(KERNELS)
    need = sum(w["encoder"]["layers"] * least_seconds(
        attention_bytes(w["encoder"]), attention_ops(w["encoder"]), PEAK_BF16)
        for w in run.work if "encoder" in w)
    return 100.0 * need / spent if spent > 0 and need > 0 else None
