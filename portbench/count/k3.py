"""The roofline of the best-match kernel (K3, ``best_match``), frozen from
``chip_smoke.py``'s ``bound``: one call over ``B`` images of ``HW`` pixels
with ``D`` channels and ``Q`` queries reads each input once and writes each
output once, and needs ``2*Q*HW*D + 2*Q*HW`` float32 operations per
image."""

from portbench.count.peaks import PEAK_FP32_FLOP_S, PEAK_HBM_BYTES_S


def k3_bytes(B: int, Q: int, D: int, HW: int) -> int:
    """Descriptors and queries read, one int32 index and one float32
    distance written per query."""
    return 4 * (B * HW * D + B * Q * D) + 8 * B * Q


def k3_ops(B: int, Q: int, D: int, HW: int) -> int:
    return B * (2 * Q * HW * D + 2 * Q * HW)


def k3_bound_s(B: int, Q: int, D: int, HW: int):
    """``(seconds, "bytes" | "operations")``: the least time of one call and
    which of the two bounds it."""
    t_bytes = k3_bytes(B, Q, D, HW) / PEAK_HBM_BYTES_S
    t_ops = k3_ops(B, Q, D, HW) / PEAK_FP32_FLOP_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
