"""``mfu.train``: the window's completed train steps' convolution FLOPs
(:func:`portbench.count.flops.train_step_flops`) over the window's device
time (CUDA events), as a share of the card's float32 peak."""

from portbench.count.flops import train_step_flops
from portbench.count.peaks import PEAK_FP32_FLOP_S


def read(record):
    if not record.get("steps"):
        return None
    net = record["config"]["dense_correspondence_network"]
    flops = record["steps"] * train_step_flops(
        net["backbone"]["resnet_name"], net["image_height"], net["image_width"],
        net["descriptor_dimension"], record["frames_per_step"])
    return 100.0 * flops / record["window_seconds"] / PEAK_FP32_FLOP_S
