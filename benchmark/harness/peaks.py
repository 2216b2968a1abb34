"""Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, no
sparsity; at the full 700 W power limit) and the roofline bound."""

PEAK_BF16 = 989e12  # FLOP/s, bf16 and fp16 tensor cores
PEAK_INT8 = 1979e12  # OP/s
PEAK_HBM = 3.35e12  # bytes/s


def bound_s(ops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    """The least time the card could take: the larger of ``ops`` at ``peak``
    and ``nbytes`` moved once at the HBM rate."""
    return max(ops / peak, nbytes / PEAK_HBM)
