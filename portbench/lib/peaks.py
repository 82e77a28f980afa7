"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense rates,
no sparsity, at the full 700 W power limit).  A card set below 700 W runs
slower under load; every run prints the card's limit beside its numbers."""

PEAK_BYTES = 3.35e12          # HBM3, bytes/s
PEAK_BF16 = 989e12            # tensor cores, bf16 FLOP/s
PEAK_INT8 = 1979e12           # tensor cores, int8 OP/s
PEAK_FP32 = 67e12             # FP32 lanes outside the tensor cores, FLOP/s
PEAK_TF32 = 495e12            # tensor cores, TF32 FLOP/s
# An f32-accurate product runs on the FP32 lanes or as three TF32 products
# (hi.hi + hi.lo + lo.hi): the least time is the lesser of the two.
PEAK_F32_PRODUCT = max(PEAK_FP32, PEAK_TF32 / 3)
# exp and log run on the special-function units: 16 an SM against 128 FP32
# lanes, each of which counts 2 FLOP in PEAK_FP32.
PEAK_SFU = PEAK_FP32 / 2 / 8


def least_seconds(bytes_moved: float, ops: float, peak_ops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory's rate and the operations over their peak."""
    return max(bytes_moved / PEAK_BYTES, ops / peak_ops)
