"""``dinov2.mfu.train``: the window's completed train steps' FLOPs of the
DINOv2 network (the driver's ``dinov2_step_flops``,
:func:`portbench.count.dinov2.train_step_flops`) over the window's device
time (CUDA events), as a share of the card's float32 peak."""

from portbench.count.peaks import PEAK_FP32_FLOP_S


def read(record):
    flops = record.get("dinov2_step_flops")
    if not flops or not record.get("steps"):
        return None
    return 100.0 * record["steps"] * flops / record["window_seconds"] / PEAK_FP32_FLOP_S
