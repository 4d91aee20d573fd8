"""``portbench/alltrace.py``: the idle time of a made-up trace put down to the
server's spans, and a tiny traced run on the CPU under a profiler that
records every thread, whose trace holds every span of the server."""

import pytest
import torch

from portbench import alltrace
from portbench.tests.cpu_run import run_cpu

WINDOW = "portbench.window"


def _event(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur, "tid": 1}


def test_idle_time_by_the_servers_spans():
    """Window 0-100 us, the device busy 10-20 and 50-60 us."""
    events = [_event(WINDOW, "user_annotation", 0, 100),
              _event("k", "kernel", 10, 10), _event("copy", "gpu_memcpy", 50, 10),
              _event("serve.device_wait", "user_annotation", 5, 15),
              _event("serve.fanout", "user_annotation", 25, 5),
              _event("serve.starved", "user_annotation", 35, 20),
              _event("serve.reply", "user_annotation", 22, 6)]
    a = alltrace.analyse(events, WINDOW)
    us = 1e-6
    assert a["window_s"] == pytest.approx(100 * us) and a["busy_s"] == pytest.approx(20 * us)
    assert a["idle_s"] == pytest.approx(80 * us)
    assert a["idle_by_batcher_span_s"] == pytest.approx({
        "before any span": 5 * us, "serve.device_wait": 5 * us,
        "after serve.device_wait": 5 * us, "serve.fanout": 5 * us,
        "after serve.fanout": 5 * us, "serve.starved": 15 * us, "after serve.starved": 40 * us})
    both = a["idle_by_batcher_and_handler_s"]
    assert both["after serve.device_wait | serve.reply"] == pytest.approx(3 * us)
    assert both["serve.fanout | serve.reply"] == pytest.approx(3 * us)
    # no span of either thread: before 5, 20-22, 30-35, after 60
    assert a["unlabelled_s"] == pytest.approx(52 * us)
    assert a["span_counts"] == {"serve.device_wait": 1, "serve.fanout": 1, "serve.starved": 1,
                                "serve.reply": 1}


def test_a_tiny_run_records_every_span(monkeypatch):
    from torch._C._profiler import _ExperimentalConfig

    try:
        _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        pytest.skip(f"torch {torch.__version__}'s profiler cannot record every thread")
    # the trace's end synchronises the card; a CPU run has no queue to drain
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    with alltrace.recording() as got:
        res, _ = run_cpu("serve.resnet34_8s.c1", seed=2**31 + 991, seconds=1.0, trace=True)
    assert res["correct"], res["checks"]
    out = alltrace.summary(got)
    counts = out["analysis"]["span_counts"]
    assert set(counts) >= set(alltrace.BATCHER) | set(alltrace.HANDLER), counts
    d = out["window_stats"]
    assert d["dispatches"] > 0 and counts["serve.device_wait"] >= d["dispatches"]
    assert set(out["window_ms_per_dispatch"]) == set(alltrace.PHASES)
    assert 0.8 < out["phases_over_window"] < 1.2 and out["profiler_start_s"] > 0
    # the wrappers are gone after the run
    from portbench import trace
    assert trace.Tracer.start.__module__ == "portbench.trace"
