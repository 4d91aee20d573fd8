"""``mfu.serve``: the frames the server forwarded in the window (padding to
a batch bucket not counted; ``stats`` ``frames``) times one frame's
convolution FLOPs, over the window's seconds, as a share of the card's
float32 peak."""

from portbench.count.flops import forward_flops
from portbench.count.peaks import PEAK_FP32_FLOP_S


def read(record):
    frames = record.get("server_stats", {}).get("frames")
    if not frames:
        return None
    net = record["config"]["dense_correspondence_network"]
    flops = frames * forward_flops(net["backbone"]["resnet_name"], net["image_height"],
                                   net["image_width"], net["descriptor_dimension"])
    return 100.0 * flops / record["window_seconds"] / PEAK_FP32_FLOP_S
