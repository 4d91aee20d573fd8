"""The readings that the limits of ``correct`` are set from, for the cells of
the ``train_vit`` driver, on the card:

    python3 portbench/control_vit.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]
                                     [--out <file.jsonl>]

As :mod:`portbench.control` reads the ``train`` cells: for each seed, the
program's compared numbers from its first checked steps; on the control
seeds, those of the control (the plain reference in the program's place,
in TF32), of the fault (the reference's loss over half the batch) and of
the reference again. The last line sums them up as ``control.py``'s does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(ctx, control: bool) -> dict:
    import torch

    from portbench.control import worst_leaves
    from portbench.reference.train_step import BETA1
    from portbench.scenes import make_scenes
    from portbench.seeds import torch_generator
    from portbench.traffic import train as T
    from portbench.traffic import train_vit as V
    from portbench.weights_dinov2 import make_weights

    tc = T.training_config(ctx.config, ctx.params)
    net = tc["dense_correspondence_network"]
    n = T.CHECKED_STEPS
    scenes = make_scenes(ctx.seed, ctx.config["scenes"], ctx.device)
    weights = make_weights(int(net["descriptor_dimension"]), V.widths(net), ctx.seed, ctx.device)
    state, step, cache = T.build_program(ctx, scenes, weights, tc)
    program = T.checked_steps(state, step, torch_generator(ctx.seed, "train", ctx.device), n)
    del state, step, cache, weights
    torch.cuda.empty_cache()
    oracle = V.reference_steps(ctx, scenes, tc, n)
    out = {"program": T.compare(program, oracle),
           "losses": {"program": program["losses"], "reference": oracle[0]},
           "worst_leaf": worst_leaves(program, oracle)}
    if control:
        for side, kwargs in (("control_tf32", {"tf32": True}),
                             ("fault_half_batch", {"batch_fraction": 0.5}),
                             ("reference_again", {})):
            losses, grads, before, after = V.reference_steps(ctx, scenes, tc, n, **kwargs)
            planted = {"losses": losses, "before": before, "after": after,
                       "first_moments": {k: g * (1.0 - BETA1) for k, g in grads.items()}}
            out[side] = T.compare(planted, oracle)
            out["losses"][side] = losses
            out["worst_leaf"][side] = worst_leaves(planted, oracle)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness
    from portbench.control import judged

    harness.require_cards(1)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    files = harness.cell_files(args.workload)
    if files["workload"]["driver"] != "train_vit":
        raise SystemExit(f"{args.workload} is no train_vit cell: use portbench/control.py")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    lines = []
    print(f"card: {harness.card_line()}", flush=True)
    for seed in seeds:
        t0 = time.perf_counter()
        ctx = harness.Context(args.workload, files, seed, 0.0, False, device, t0)
        out = readings(ctx, seed in control)
        out["correct"] = judged(out, ctx.limits)
        line = {"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t0, **out}
        lines.append(line)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    summary = {}
    for side in ("program", "control_tf32", "fault_half_batch", "reference_again"):
        values = [line[side] for line in lines if side in line]
        if values:
            pick = max if side == "program" else min
            summary[side] = {k: pick(v[k] for v in values) for k in values[0]}
    as_should = all(ok == (side == "program") for line in lines
                    for side, ok in line["correct"].items())
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "every_seed_as_it_should": as_should}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
