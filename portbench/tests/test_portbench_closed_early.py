"""The reader ``serve.closed_early_share``: on made-up window deltas of the
server's ``stats``, nothing where the server does not count
``closed_early``, its entry in ``BENCHMARK.json``, and a tiny traced run of
the one-client cell on the CPU, where every dispatch closes early."""

import pytest
import torch

from portbench import harness
from portbench.tests.cpu_run import run_cpu

SPEC = harness.benchmark_spec()
NAME = "serve.closed_early_share"
DELTA = {"requests": 130, "dispatches": 40, "frames": 125, "match_dispatches": 31,
         "gather_s": 0.2, "closed_early": 30}


def read(record):
    return harness.load_module(harness.PKG / "metrics" / f"{NAME}.py", "reader_closed_early").read(
        record)


@pytest.mark.parametrize("closed, want", [(30, 75.0), (0, 0.0), (40, 100.0)])
def test_reader_on_a_made_up_delta(closed, want):
    assert read({"server_stats": dict(DELTA, closed_early=closed)}) == pytest.approx(want)


def test_reader_reads_nothing_where_nothing_is_counted():
    assert read({}) is None
    assert read({"server_stats": {}}) is None
    assert read({"server_stats": dict(DELTA, dispatches=0)}) is None  # no dispatch in the window
    # a server that does not count closed_early (the program before it closed a gather early)
    assert read({"server_stats": {k: v for k, v in DELTA.items() if k != "closed_early"}}) is None


def test_entry():
    entry = next(m for m in SPEC["per_layer"] if m["name"] == NAME)
    assert entry["unit"] == "%" and entry["better"] == "higher"
    assert entry["source"] == "program_counter" and entry["moves"] == "serve_frames_per_s"
    assert entry["layer"] == "batcher: apps/serve.py DescriptorServer._batch_loop"
    cells = {w["name"]: w for w in SPEC["workloads"]}
    assert entry["workloads"] == [w for w in cells if cells[w]["traffic"].startswith("serve_")]


def test_a_traced_cpu_run_of_one_client_closes_every_dispatch_early(monkeypatch):
    # the trace's end synchronises the card; a CPU run has no queue to drain
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    res, out = run_cpu("serve.resnet34_8s.c1", seed=2**31 + 991, seconds=1.0, trace=True)
    assert res["correct"], res["checks"]
    assert out["server_stats"]["dispatches"] > 0
    metric = res["metrics"][NAME]
    assert metric["unit"] == "%" and metric["value"] == 100.0, metric
