"""The readings that the limits of ``correct`` are set from, on the card:

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]
                                 [--seconds 3] [--out <file.jsonl>]

For each seed, in one process: the program's compared numbers, as a run
of the cell computes them (the train cells' first checked steps, the serve
cells' answers in a window of ``--seconds``); and, on the control seeds,
the same numbers of the control, the plain reference put in the program's
place and computed in TF32 (the configurations state float32 without
TF32), and of the faults a cell can have, planted in the reference: for
the train cells, the loss averaged over half the batch. A state left
unchanged reads 1 by the train cells' measure and needs no run. Each
side's numbers are judged as a run judges its own, against the cell's
limits (:func:`harness.checks_of`, :func:`harness.judge`); a number that
a control or a fault does not give (a served request's failure) takes
the program's. Each reading is a JSON line with every side's ``correct``;
the last line sums them up per number: the program's largest (the lower
reading) and the control's and each fault's smallest (the upper
readings), and whether every seed came out as it should (the program
correct, every control and fault not).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def train_readings(ctx, control: bool):
    import torch

    from portbench.reference.train_step import BETA1
    from portbench.scenes import make_scenes
    from portbench.seeds import torch_generator
    from portbench.traffic import train as T
    from portbench.weights import make_weights

    tc = T.training_config(ctx.config, ctx.params)
    net = tc["dense_correspondence_network"]
    n = T.CHECKED_STEPS
    scenes = make_scenes(ctx.seed, ctx.config["scenes"], ctx.device)
    weights = make_weights(net["backbone"]["resnet_name"], net["descriptor_dimension"],
                           ctx.seed, ctx.device)
    state, step, cache = T.build_program(ctx, scenes, weights, tc)
    program = T.checked_steps(state, step, torch_generator(ctx.seed, "train", ctx.device), n)
    del state, step, cache, weights
    torch.cuda.empty_cache()
    oracle = T.reference_steps(ctx, scenes, tc, n)
    out = {"program": T.compare(program, oracle),
           "losses": {"program": program["losses"], "reference": oracle[0]},
           "worst_leaf": worst_leaves(program, oracle)}
    if control:
        # the control, a fault, and the reference again (its own spread,
        # from the card's backward that is not bit-reproducible)
        for side, kwargs in (("control_tf32", {"tf32": True}),
                             ("fault_half_batch", {"batch_fraction": 0.5}),
                             ("reference_again", {})):
            losses, grads, before, after = T.reference_steps(ctx, scenes, tc, n, **kwargs)
            planted = {"losses": losses, "before": before, "after": after,
                       "first_moments": {k: g * (1.0 - BETA1) for k, g in grads.items()}}
            out[side] = T.compare(planted, oracle)
            out["losses"][side] = losses
            out["worst_leaf"][side] = worst_leaves(planted, oracle)
    return out


def worst_leaves(program: dict, reference) -> dict:
    """The leaves that set the gradient's and the change's gaps."""
    from portbench.reference.train_step import BETA1, leaf_gaps

    _, grads, before, after = reference
    first = {k: m / (1.0 - BETA1) for k, m in program["first_moments"].items()}
    change_p = {k: program["after"][k] - program["before"][k] for k in grads}
    change_r = {k: after[k] - before[k] for k in grads}
    out = {}
    for name, gaps in (("grad", leaf_gaps(first, grads)), ("change", leaf_gaps(change_p, change_r))):
        k = max(gaps, key=gaps.get)
        out[name] = [k, gaps[k], tuple(grads[k].shape)]
    return out


def serve_readings(ctx, control: bool):
    import torch

    from portbench.reference.descriptors import best_matches, check_answers, descriptor_images
    from portbench.reference.resnet import ResNetFCN
    from portbench.traffic import serve_closed_loop as S
    from portbench.weights import make_weights

    run = S.run(ctx)
    out = {"program": {k: c["value"] for k, c in run["checks"].items()}}
    if control:
        frames, queries, records, descriptors = run["answers"]
        net = ctx.config["dense_correspondence_network"]
        name, D = net["backbone"]["resnet_name"], int(net["descriptor_dimension"])
        model = ResNetFCN(name, D).to(ctx.device).eval()
        model.load_state_dict(make_weights(name, D, ctx.seed, ctx.device))
        x = torch.as_tensor(frames, device=ctx.device)
        oracle = descriptor_images(model, x)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            low = descriptor_images(model, x)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        matches = []
        for r in records:
            if r["error"] is None and r["op"] == "best_match":
                q = queries[r["query_set"]]
                uv, dist = best_matches(low[r["frame"]], torch.as_tensor(q, device=ctx.device))
                matches.append((r["frame"], q, uv.cpu().numpy(), dist.cpu().numpy()))
        served = [(frame, low[frame].cpu().numpy()) for _, _, frame, _ in descriptors]
        out["control_tf32"] = check_answers(oracle, matches, served)
    return out


def judged(readings: dict, limits: dict) -> dict:
    """``{side: correct}`` of the readings of one seed, each side's
    numbers held to the cell's limits as a run holds its own."""
    from portbench import harness

    program = readings["program"]
    return {side: harness.judge(harness.checks_of(dict(program, **readings[side]), limits))
            for side in readings if side == "program" or side.startswith(("control", "fault"))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    harness.require_cards(1)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    files = harness.cell_files(args.workload)
    kind = files["workload"]["driver"]
    readings = {"train": train_readings, "serve_closed_loop": serve_readings}[kind]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    lines, sink = [], open(args.out, "a") if args.out else None
    print(f"card: {harness.card_line()}", flush=True)
    for seed in seeds:
        t0 = time.perf_counter()
        ctx = harness.Context(args.workload, files, seed, args.seconds, False, device, t0)
        out = readings(ctx, seed in control)
        out["correct"] = judged(out, ctx.limits)
        line = {"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t0, **out}
        lines.append(line)
        print(json.dumps(line), flush=True)
        if sink:
            sink.write(json.dumps(line) + "\n")
            sink.flush()
    summary = {}
    for side in {k for line in lines for k in line
                 if k not in ("workload", "seed", "seconds", "losses", "worst_leaf", "correct")}:
        values = [line[side] for line in lines if side in line]
        pick = max if side == "program" else min
        summary[side] = {k: pick(v[k] for v in values) for k in values[0]}
    as_should = all(ok == (side == "program") for line in lines
                    for side, ok in line["correct"].items())
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "every_seed_as_it_should": as_should}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
