"""Runs of a cell on the CPU at a tiny size, for the tests: the harness's
look for a card is skipped, the rest of a run is driven as on the card
(the program's kernels take their plain versions on CPU tensors)."""

from __future__ import annotations

import copy

import torch

from portbench import harness

TINY = {
    "scenes": {"num_scenes": 2, "frames_per_scene": 4, "width": 64, "height": 48},
    "dense_correspondence_network": {"image_width": 64, "image_height": 48},
    "training": {"num_matching_attempts": 200, "masked_pool_size": 64,
                 "background_pool_size": 64, "num_blind_samples": 100},
}
TINY_PARAMS = {"train": {"batch_size": 2, "steps_per_dispatch": 2, "logging_rate": 4},
               "serve_closed_loop": {"frames": 4, "queries": 4, "query_sets": 4,
                                     "warmup_requests": 1, "checked_descriptors": 2}}


def tiny_files(cell: str, clients=None) -> dict:
    files = harness.cell_files(cell)
    cfg = copy.deepcopy(files["config"])
    for group, values in TINY.items():
        cfg[group].update(values)
    wl = copy.deepcopy(files["workload"])
    wl["params"].update(TINY_PARAMS[wl["driver"]])
    if clients is not None:
        wl["params"]["clients"] = clients
    return dict(files, config=cfg, workload=wl)


def run_cpu(cell: str, seed: int = 1, seconds: float = 1.0, trace: bool = False,
            files=None, traffic=None):
    """``(result line, driver output)`` of one tiny run on the CPU."""
    import importlib
    import time

    files = files or tiny_files(cell)
    spec = harness.benchmark_spec()
    e2e, layer = harness.cell_metrics(spec, cell)
    ctx = harness.Context(cell, files, seed, seconds, trace, torch.device("cpu"),
                          time.perf_counter())
    traffic = traffic or importlib.import_module("portbench.traffic." + files["workload"]["driver"])
    out = traffic.run(ctx)
    return harness.make_result(ctx, out, e2e, layer), out
