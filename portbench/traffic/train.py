"""Traffic ``train``: the port's training job on its default route, the
device-sampler route of ``DenseCorrespondenceTraining`` (K train steps a
call, one CUDA graph replayed K times).

Set-up makes the scenes and the weights from the seed on the device, puts
the scenes in the program's device cache, and builds the training state
and the scanned step as the trainer builds them
(``make_scanned_train_step``). It captures the step's graph, then drives
that same object through its first :data:`CHECKED_STEPS` steps, one step a
call, keeping what the check needs: the parameters before, Adam's first
moments after the first step, the parameters after the last, and each
step's loss. Then the window: calls of ``steps_per_dispatch`` steps, the
metrics fetched to the host every ``logging_rate`` steps as the trainer
fetches them. The window is timed by the device: an event after each
call; it ends when the first call that completes at or after
``--seconds`` completes, and counts whole calls only. In a traced run,
after the window, the cell's ``enqueue_probe_calls`` more calls (none
where the cell gives none) are each made with the device's queue drained
first, and the host's time in each is kept: the cost of enqueueing a
call, which inside the window hides behind the host's wait for room in
the launch queue. A cell gives them only where the launch queue holds a
whole call of its graph's replays: otherwise even a drained call waits.

After the window the program is freed and the plain reference
(:mod:`portbench.reference.train_step`) takes the same first steps from
the same seed, weights and scenes. Compared: the first step's loss
(relative gap); the first gradient as Adam took it, by the worst leaf;
and the parameters' change over the checked steps, by the median leaf.
A leaf's gap is the gap of the two norms over the larger of the
reference's norm and the median leaf's; leaves whose reference gradient
is under a thousandth of the median leaf's are left out of the change.
The later steps' losses and the worst leaf's change are not compared:
the card's backward is not bit-reproducible, and two runs of the
reference itself part by up to a few percent there (``PERF.md``).
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from portbench import harness
from portbench.reference.resnet import ResNetFCN
from portbench.reference.train_step import ReferenceTraining, leaf_gap, leaf_gaps
from portbench.scenes import make_scenes
from portbench.seeds import torch_generator
from portbench.weights import make_weights

ADAM_BETA1 = 0.9
# the program's first steps that the reference follows
CHECKED_STEPS = 3
# leaves whose reference gradient is below this share of the median leaf's
# move by round-off alone and are left out of the change
ROUNDOFF_LEAF = 1e-3


class Clock:
    """Completion marks on the device's stream (CUDA events), or on the
    host where the device is the CPU (the tests)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def done(self, m) -> bool:
        return m.query() if self.cuda else True

    def wait(self, m):
        if self.cuda:
            m.synchronize()

    def seconds(self, m0, m1) -> float:
        return m0.elapsed_time(m1) / 1e3 if self.cuda else m1 - m0


def training_config(config: dict, params: dict) -> dict:
    """The trainer's config dict of a configuration file and a cell."""
    t = dict(config["training"], batch_size=params["batch_size"],
             steps_per_dispatch=params["steps_per_dispatch"],
             logging_rate=params["logging_rate"])
    return {"training": t, "loss_function": dict(config["loss_function"]),
            "dense_correspondence_network": dict(config["dense_correspondence_network"])}


def program_dataset(scenes):
    """The scenes as the program's in-memory dataset of one object."""
    from pdc_tpu_torch.data.dataset import SceneData, SpartanDataset

    ds = SpartanDataset()
    rgb, depth, mask = (x.cpu().numpy() for x in (scenes.rgb, scenes.depth, scenes.mask))
    poses, K = scenes.poses.cpu().numpy(), scenes.K.cpu().numpy()
    for i, (off, n) in enumerate(zip(scenes.offsets, scenes.lengths)):
        sl = slice(off, off + n)
        ds.add_scene(SceneData(name=f"scene_{i:03d}", rgb=rgb[sl], depth=depth[sl].astype(np.uint16),
                               mask=mask[sl], poses=poses[sl], K=K, object_id="object_0"))
    return ds


def build_program(ctx, scenes, weights, tc):
    """``(state, step, cache)``: the program's device cache, training state
    and scanned step, built as ``DenseCorrespondenceTraining`` builds them
    on the device-sampler route."""
    from pdc_tpu_torch.data.assembler import AssemblerConfig
    from pdc_tpu_torch.data.device_cache import DeviceCache
    from pdc_tpu_torch.losses.pixelwise_contrastive import LossConfig
    from pdc_tpu_torch.models.dcn import build_backbone
    from pdc_tpu_torch.training.scanned import make_scanned_train_step
    from pdc_tpu_torch.training.train import create_train_state

    net = tc["dense_correspondence_network"]
    dataset = program_dataset(scenes)
    ctx.phase("scenes copied to the host")
    cache = DeviceCache.from_dataset(dataset, device=ctx.device)
    ctx.phase("device cache filled")
    with torch.device(ctx.device):
        module = build_backbone(net)
    module.load_state_dict(weights)
    state = create_train_state(module, tc, device=ctx.device)
    ctx.phase("network and optimizer built")
    step = make_scanned_train_step(
        tc, LossConfig.from_dict(tc["loss_function"]), AssemblerConfig.from_training_config(tc),
        net["image_width"], cache, int(ctx.params["batch_size"]),
        int(ctx.params["steps_per_dispatch"]))
    return state, step, cache


def checked_steps(state, step, generator, n: int) -> dict:
    """The first ``n`` steps, one a call of the scanned step (the graph
    captured for its K steps a call first, on a card): the losses, the
    parameters before and after, and Adam's first moments after step 1.
    The calls are the window's own, on the object the window then drives,
    with its public ``steps_per_dispatch`` set to 1 meanwhile (the same
    graph replayed once a call): a call of K steps would hide the state
    after the first step, and a second step object would not be the one
    the window times."""
    k = step.steps_per_dispatch
    if step.graphed:
        step.capture(state, generator)
    before = {name: p.detach().clone() for name, p in state.module.named_parameters()}
    step.steps_per_dispatch = 1
    losses, first = [], None
    try:
        for i in range(n):
            losses.append(step(state, generator)["loss"][0])
            if i == 0:
                # moments the optimizer never made (a step that did not run) read 0
                first = {name: state.optimizer.state.get(p, {}).get(
                    "exp_avg", torch.zeros_like(p)).detach().clone()
                    for name, p in state.module.named_parameters()}
    finally:
        step.steps_per_dispatch = k
    after = {name: p.detach().clone() for name, p in state.module.named_parameters()}
    return {"losses": [float(x) for x in losses], "before": before, "after": after,
            "first_moments": first}


def window(ctx, state, step, generator, clock: Clock):
    """The measured window. Returns ``(seconds, calls, losses)``."""
    from torch.profiler import record_function

    k = step.steps_per_dispatch
    fetch_every = max(1, int(ctx.params["logging_rate"]) // k)
    pending, losses, marks = [], [], []
    ctx.open_window()
    m0 = clock.mark()
    end, checked, per_call = None, 0, None
    while end is None:
        with record_function("portbench.dispatch"):
            metrics = step(state, generator)
        marks.append(clock.mark())
        pending.append(metrics["loss"])
        if len(marks) % fetch_every == 0:  # the trainer's logging fetch
            with record_function("portbench.fetch_metrics"):
                losses += torch.cat(pending).tolist()
            pending = []
        # which calls have completed, and when
        while checked < len(marks) and clock.done(marks[checked]):
            t = clock.seconds(m0, marks[checked])
            per_call = t / (checked + 1)
            checked += 1
            if t >= ctx.seconds:
                end = checked
                break
        # enough calls queued to pass the window's end: wait for them
        if end is None and per_call is not None and len(marks) * per_call >= ctx.seconds + per_call:
            while end is None and checked < len(marks):
                clock.wait(marks[checked])
                t = clock.seconds(m0, marks[checked])
                checked += 1
                if t >= ctx.seconds:
                    end = checked
    clock.wait(marks[end - 1])
    seconds = clock.seconds(m0, marks[end - 1])
    ctx.close_window()
    if pending:
        losses += torch.cat(pending).tolist()
    return seconds, end, losses[:end * k]


def enqueue_seconds(state, step, generator, calls: int) -> list:
    """The host's seconds in each of ``calls`` calls of the step on a
    card, each made with the device's queue drained first: the time to
    enqueue a call of K steps, without the wait for room in the launch
    queue that the window's calls spend most of their host time in."""
    out = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, generator)
        out.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return out


def reference_steps(ctx, scenes, tc, n: int, tf32: bool = False, batch_fraction: float = 1.0):
    """The plain reference's first ``n`` steps from the seed: ``(losses,
    first gradients, parameters before, parameters after)``. ``tf32`` and
    ``batch_fraction`` make the control and a fault (see
    :mod:`portbench.reference.train_step`)."""
    net = tc["dense_correspondence_network"]
    name = net["backbone"]["resnet_name"]
    weights = make_weights(name, net["descriptor_dimension"], ctx.seed, ctx.device)
    model = ResNetFCN(name, net["descriptor_dimension"]).to(ctx.device)
    model.load_state_dict(weights)
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


def compare(program: dict, reference) -> dict:
    """The compared numbers (see the module docstring)."""
    losses, grads, before, after = reference
    first = {k: m / (1.0 - ADAM_BETA1) for k, m in program["first_moments"].items()}
    norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in grads.items()}
    median = sorted(norms.values())[len(norms) // 2]
    keep = {k for k, v in norms.items() if v >= ROUNDOFF_LEAF * median}
    change_p = {k: program["after"][k] - program["before"][k] for k in grads}
    change_r = {k: after[k] - before[k] for k in grads}
    change = sorted(leaf_gaps(change_p, change_r, keep).values())
    return {"first_loss_gap": abs(program["losses"][0] - losses[0]) / abs(losses[0]),
            "grad_gap": leaf_gap(first, grads),
            "change_gap": change[len(change) // 2]}


def run(ctx) -> dict:
    tc = training_config(ctx.config, ctx.params)
    net = tc["dense_correspondence_network"]
    n_checked = CHECKED_STEPS
    scenes = make_scenes(ctx.seed, ctx.config["scenes"], ctx.device)
    weights = make_weights(net["backbone"]["resnet_name"], net["descriptor_dimension"],
                           ctx.seed, ctx.device)
    ctx.phase("scenes and weights made")
    state, step, cache = build_program(ctx, scenes, weights, tc)
    del weights
    ctx.phase("program built")
    generator = torch_generator(ctx.seed, "train", ctx.device)
    program = checked_steps(state, step, generator, n_checked)
    ctx.phase("graph captured, checked steps taken")
    clock = Clock(ctx.device)
    seconds, calls, losses = window(ctx, state, step, generator, clock)
    k = step.steps_per_dispatch
    enqueue = []
    if clock.cuda:  # calls queued past the window's end finish before the state goes
        torch.cuda.synchronize(ctx.device)
        if ctx.trace:
            enqueue = enqueue_seconds(state, step, generator,
                                      int(ctx.params.get("enqueue_probe_calls", 0)))
    peak = torch.cuda.max_memory_allocated(ctx.device) if clock.cuda else 0
    state = step = cache = None
    gc.collect()
    if clock.cuda:
        torch.cuda.empty_cache()
    numbers = compare(program, reference_steps(ctx, scenes, tc, n_checked))
    checks = harness.checks_of(numbers, ctx.limits)
    steps = calls * k
    pairs = steps * int(ctx.params["batch_size"])
    failed = sum(1 for x in losses if not math.isfinite(x))
    return {
        "correct": harness.judge(checks),
        "attempted": steps,
        "failed": failed,
        "end_to_end": {"train_pairs_per_s": pairs / seconds},
        "device": harness.device_facts(ctx.device, peak),
        "checks": checks,
        "steps": steps,
        "window_seconds": seconds,
        "enqueue_seconds_per_call": enqueue,
        "frames_per_step": 2 * int(ctx.params["batch_size"]),
    }
