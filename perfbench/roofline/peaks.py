"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): 3.35 TB/s of HBM3, 67 TFLOP/s in float32
outside the tensor cores, half that for code built without fused
multiply-adds (each operation one instruction a lane). A share of a
roofline is stated against these, with the card's power limit beside it."""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP32_NONFMA_OPS_PER_S = 33.5e12


def least_seconds(n_bytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """The least time the card could take: the larger of the bytes over the
    memory's rate and the operations over the arithmetic's, and which."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
