"""``dinov2.attn_roofline``: the attention's share of its roofline in the
traced window: the least time of a train step's attention (the driver's
``dinov2_attention_work``, bounded by
:func:`portbench.count.dinov2.attention_bound_s`) times the steps whose
attention the trace holds, over the device time of the fused attention
kernels, forward and backward, matched by name. The steps are the forward
kernels' launches over the blocks a step has: the trace's window may hold
more steps than the window's count, as calls queued ahead run into it."""

from portbench.count.dinov2 import attention_bound_s

# PyTorch's memory-efficient kernels (fmha_cutlassF/fmha_cutlassB) and flash kernels
FORWARD, BACKWARD = ("fmha_cutlassF", "flash_fwd"), ("fmha_cutlassB", "flash_bwd")


def read(record):
    trace, work = record.get("trace"), record.get("dinov2_attention_work")
    if not trace or not work:
        return None
    kernels = [(name, d) for name, _, d, _ in trace["kernels"]
               if any(n in name for n in FORWARD + BACKWARD)]
    forward = sum(1 for name, _ in kernels if any(n in name for n in FORWARD))
    if not forward:
        return None
    depth = int(record["config"]["dense_correspondence_network"]["backbone"].get("depth", 24))
    us = sum(d for _, d in kernels)
    return 100.0 * (forward / depth) * attention_bound_s(work) / (us * 1e-6)
