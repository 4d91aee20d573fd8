"""Traffic ``train_vit``: the training job of :mod:`portbench.traffic.train`
(the device-sampler route, K train steps a call in one CUDA graph) with a
DINOv2 ViT backbone (``backbone.model_class: Dinov2``). Set-up, the
checked steps, the window and the comparison are ``train``'s own
functions; the weights (:mod:`portbench.weights_dinov2`) and the plain
reference (:mod:`portbench.reference.dinov2`) are this driver's.

Besides ``train``'s record, a run writes what the ViT's per-layer metrics
read: the FLOPs of one train step (``dinov2_step_flops``,
:func:`portbench.count.dinov2.train_step_flops`) and the attention's work
in one step (``dinov2_attention_work``,
:func:`portbench.count.dinov2.attention_work`)."""

from __future__ import annotations

import gc
import math

import torch

from portbench import harness
from portbench.count.dinov2 import attention_work, train_step_flops
from portbench.reference.dinov2 import Dinov2FCN
from portbench.reference.train_step import ReferenceTraining
from portbench.scenes import make_scenes
from portbench.seeds import torch_generator
from portbench.traffic.train import (
    CHECKED_STEPS,
    Clock,
    build_program,
    checked_steps,
    compare,
    enqueue_seconds,
    training_config,
    window,
)
from portbench.weights_dinov2 import make_weights


def widths(net: dict) -> dict:
    """The backbone block's widths."""
    return {k: v for k, v in net["backbone"].items() if k not in ("model_class", "pretrained")}


def reference_steps(ctx, scenes, tc, n: int, tf32: bool = False, batch_fraction: float = 1.0):
    """The plain reference's first ``n`` steps from the seed, as
    :func:`portbench.traffic.train.reference_steps` takes them: ``(losses,
    first gradients, parameters before, parameters after)``."""
    net = tc["dense_correspondence_network"]
    D = int(net["descriptor_dimension"])
    model = Dinov2FCN(D, **widths(net)).to(ctx.device)
    model.load_state_dict(make_weights(D, widths(net), ctx.seed, ctx.device))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    ref = ReferenceTraining(model, scenes, tc, int(ctx.params["batch_size"]),
                            torch_generator(ctx.seed, "train", ctx.device), batch_fraction)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        losses = [ref.step() for _ in range(n)]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    after = {k: p.detach().clone() for k, p in model.named_parameters()}
    return losses, ref.first_gradients, before, after


def run(ctx) -> dict:
    from pdc_tpu_torch.models.dcn import build_backbone

    tc = training_config(ctx.config, ctx.params)
    net = tc["dense_correspondence_network"]
    D, H, W = (int(net[k]) for k in ("descriptor_dimension", "image_height", "image_width"))
    with torch.device("meta"):  # a program without the backbone fails here, before set-up
        build_backbone(net)
    scenes = make_scenes(ctx.seed, ctx.config["scenes"], ctx.device)
    weights = make_weights(D, widths(net), ctx.seed, ctx.device)
    ctx.phase("scenes and weights made")
    state, step, cache = build_program(ctx, scenes, weights, tc)
    del weights
    ctx.phase("program built")
    generator = torch_generator(ctx.seed, "train", ctx.device)
    program = checked_steps(state, step, generator, CHECKED_STEPS)
    ctx.phase("graph captured, checked steps taken")
    clock = Clock(ctx.device)
    seconds, calls, losses = window(ctx, state, step, generator, clock)
    enqueue = []
    if clock.cuda:  # calls queued past the window's end finish before the state goes
        torch.cuda.synchronize(ctx.device)
        if ctx.trace:
            enqueue = enqueue_seconds(state, step, generator,
                                      int(ctx.params.get("enqueue_probe_calls", 0)))
    steps = calls * step.steps_per_dispatch
    peak = torch.cuda.max_memory_allocated(ctx.device) if clock.cuda else 0
    state = step = cache = None
    gc.collect()
    if clock.cuda:
        torch.cuda.empty_cache()
    numbers = compare(program, reference_steps(ctx, scenes, tc, CHECKED_STEPS))
    checks = harness.checks_of(numbers, ctx.limits)
    frames = 2 * int(ctx.params["batch_size"])
    return {
        "correct": harness.judge(checks),
        "attempted": steps,
        "failed": sum(1 for x in losses if not math.isfinite(x)),
        "end_to_end": {"train_pairs_per_s": steps * int(ctx.params["batch_size"]) / seconds},
        "device": harness.device_facts(ctx.device, peak),
        "checks": checks,
        "steps": steps,
        "window_seconds": seconds,
        "enqueue_seconds_per_call": enqueue,
        "frames_per_step": frames,
        "dinov2_step_flops": train_step_flops(widths(net), H, W, D, frames),
        "dinov2_attention_work": attention_work(widths(net), H, W, frames),
    }
