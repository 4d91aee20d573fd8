"""The readers of the descriptor server's own counters (``serve.*_ms_per_dispatch``,
``serve.queue_wait_ms``, ``serve.handler_ms_per_request``): each on a made-up
window delta of ``stats``, nothing where there is nothing to read, and all
eight in the line of a tiny traced run on the CPU."""

import pytest
import torch

from portbench import harness
from portbench.tests.cpu_run import run_cpu

SPEC = harness.benchmark_spec()
# metric -> (stats key, denominator)
READERS = {
    "serve.starved_ms_per_dispatch": ("starved_s", "dispatches"),
    "serve.gather_ms_per_dispatch": ("gather_s", "dispatches"),
    "serve.upload_ms_per_dispatch": ("upload_s", "dispatches"),
    "serve.device_wait_ms_per_dispatch": ("device_wait_s", "dispatches"),
    "serve.download_ms_per_dispatch": ("download_s", "dispatches"),
    "serve.host_ms_per_dispatch": ("batcher_host_s", "dispatches"),
    "serve.queue_wait_ms": ("queue_wait_s", "frames"),
    "serve.handler_ms_per_request": ("handler_s", "frames"),
}
DELTA = {"requests": 130, "dispatches": 40, "frames": 125, "match_dispatches": 31,
         "starved_s": 0.8, "gather_s": 0.2, "upload_s": 0.12, "device_wait_s": 6.4,
         "download_s": 1.6, "batcher_host_s": 0.88, "queue_wait_s": 9.5, "handler_s": 2.5}


def reader(name):
    return harness.load_module(harness.PKG / "metrics" / f"{name}.py",
                               "reader_" + name.replace(".", "_"))


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_a_made_up_delta(name):
    key, den = READERS[name]
    want = 1e3 * DELTA[key] / DELTA[den]
    assert reader(name).read({"server_stats": DELTA}) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_nothing_where_nothing_is_counted(name):
    key, den = READERS[name]
    read = reader(name).read
    assert read({}) is None
    assert read({"server_stats": {}}) is None
    assert read({"server_stats": dict(DELTA, **{den: 0})}) is None  # no dispatch in the window
    # a server without the counter (the program before it counted its phases)
    assert read({"server_stats": {k: v for k, v in DELTA.items() if k != key}}) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_entries(name):
    entry = next(m for m in SPEC["per_layer"] if m["name"] == name)
    assert entry["unit"] == "ms" and entry["better"] == "lower"
    assert entry["source"] == "program_counter" and entry["moves"] == "serve_frames_per_s"
    cells = {w["name"]: w for w in SPEC["workloads"]}
    assert entry["workloads"] and all(
        cells[w]["traffic"].startswith("serve_") for w in entry["workloads"])
    assert entry["layer"] == ("handlers: apps/serve.py DescriptorServer._handle_request"
                              if name == "serve.handler_ms_per_request"
                              else "batcher: apps/serve.py DescriptorServer._batch_loop")


def test_starved_time_before_the_window_is_not_the_windows():
    """The stats' delta spans the profiler's start in a traced run: the
    phases' excess over the trace's window is starved time before it. An
    excess that is not starved time, or a sum short of the window, is a
    miscount, and reads as nothing."""
    read = reader("serve.starved_ms_per_dispatch").read
    phases = sum(DELTA[k] for k, den in READERS.values() if den == "dispatches")  # 10 s
    assert read({"server_stats": DELTA, "window_seconds": phases}) == pytest.approx(20.0)
    assert read({"server_stats": DELTA, "window_seconds": phases + 0.1}) == pytest.approx(20.0)
    trace = {"window_s": phases - 0.5}
    assert read({"server_stats": DELTA, "window_seconds": 9.0, "trace": trace}) == pytest.approx(
        1e3 * 0.3 / 40)
    # all the starved time before the window, within the edges' tolerance
    assert read({"server_stats": DELTA, "trace": {"window_s": phases - 0.9}}) == 0.0
    # more excess than starved time: a phase counted too much
    assert read({"server_stats": DELTA, "trace": {"window_s": 5.0}}) is None
    # the phases short of the window: a phase counted too little
    assert read({"server_stats": DELTA, "window_seconds": 12.0}) is None


def test_the_dispatch_phases_add_up_to_the_batchers_time():
    total = sum(reader(n).read({"server_stats": DELTA}) for n, (_, den) in READERS.items()
                if den == "dispatches")
    phases = sum(DELTA[k] for k, den in READERS.values() if den == "dispatches")
    assert total == pytest.approx(1e3 * phases / DELTA["dispatches"])


def test_a_traced_cpu_run_reports_every_reader(monkeypatch):
    # the trace's end synchronises the card; a CPU run has no queue to drain
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    res, out = run_cpu("serve.resnet34_8s.c1", seed=2**31 + 777, seconds=1.0, trace=True)
    assert res["correct"], res["checks"]
    for name in READERS:
        assert name in res["metrics"] and res["metrics"][name]["unit"] == "ms", res["metrics"]
        assert res["metrics"][name]["value"] >= 0
    stats = out["server_stats"]
    per_dispatch = sum(res["metrics"][n]["value"] for n, (_, den) in READERS.items()
                       if den == "dispatches")
    # the phases add up to the window, the starved time before it left out
    covered = per_dispatch * stats["dispatches"] * 1e-3
    assert covered == pytest.approx(res["device"]["window_s"], rel=0.05)
