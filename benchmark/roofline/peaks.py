"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit). A roofline share is taken against
these, with the card's power limit reported beside the run."""
BF16_FLOPS = 989e12      # bf16 / fp16 tensor cores, dense
HBM_BYTES = 3.35e12      # HBM3, bytes/s


def bound_s(flops: float, nbytes: float, flops_peak: float = BF16_FLOPS
            ) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(flops / flops_peak, nbytes / HBM_BYTES)
