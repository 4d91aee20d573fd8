"""Data-sheet peaks of one NVIDIA H100 SXM (dense rates, no sparsity), at
its full power limit of 700 W. Every share of a peak is stated against
these, with the card's power limit printed beside it."""

# float32 outside the tensor cores (the port's default: TF32 off)
PEAK_FP32_FLOP_S = 67e12
# HBM3
PEAK_HBM_BYTES_S = 3.35e12
