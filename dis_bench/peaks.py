"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): the yardstick of every roofline
share. Every kernel of the flow path does float32 work on the CUDA cores.
"""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def least_s(nbytes: float, flops: float) -> float:
    """The least time the card could take for the work: the larger of
    its bytes over the memory rate and its operations over the float32
    rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)
