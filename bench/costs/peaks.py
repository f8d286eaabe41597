"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
power limit): HBM bandwidth, the bfloat16 tensor-core rate and the float32
rate of the CUDA cores."""

PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_OPS_PER_S = 989e12
PEAK_F32_OPS_PER_S = 67e12


def matrix_rate(dtype_bytes: int) -> float:
    """Peak operations per second of a product on operands of this size:
    two-byte operands may use the tensor cores, float32 runs on the CUDA
    cores."""
    return PEAK_BF16_OPS_PER_S if dtype_bytes == 2 else PEAK_F32_OPS_PER_S


def least_seconds(nbytes: float, ops: float, rate: float) -> float:
    """The least time a call can take: bytes at the HBM rate or operations
    at ``rate``, whichever is longer."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / rate)
