"""The traffic drivers' bookkeeping on synthetic timestamps: the serving
window's cut, percentile and failure counts, the training window's end
and whole calls, and the serving mix."""

import math
import types

import pytest
import torch

from portbench.traffic import serve_closed_loop as S
from portbench.traffic import train as T


def rec(sent, done, error=None):
    return {"sent": sent, "done": done, "error": error}


def test_serving_window_cut_percentile_and_failures():
    # 20 requests sent in [0, 10): latencies 0.1 .. 2.0 s; one sent before,
    # one after the window; the last two answered after its end; one failed
    records = [rec(i * 0.5, i * 0.5 + 0.1 * (i + 1)) for i in range(20)]
    records += [rec(-0.5, 0.2), rec(10.0, 10.1), rec(3.0, 3.1, "RuntimeError: x")]
    out = S.window_stats(records, 0.0, 10.0, 10.0)
    assert out["attempted"] == 21 and out["failed"] == 1
    # answered in the window: done <= 10 among the 20 good ones (i*0.6+0.1 <= 10 -> i <= 16)
    assert out["serve_frames_per_s"] == pytest.approx(17 / 10.0)
    lat = sorted(0.1 * (i + 1) * 1e3 for i in range(20))
    # linear between order statistics: rank 0.95 * 19 = 18.05
    assert out["serve_p95_ms"] == pytest.approx(lat[18] + 0.05 * (lat[19] - lat[18]))


def test_serving_window_without_answers_reads_infinite_latency():
    out = S.window_stats([rec(1.0, 2.0, "OSError: reset")], 0.0, 10.0, 10.0)
    assert out["failed"] == 1 and math.isinf(out["serve_p95_ms"])


@pytest.mark.parametrize("share,clients,expect", [
    (0.5, 16, {"descriptors": 8, "best_match": 8}), (1.0, 1, {"best_match": 16})])
def test_serving_mix(share, clients, expect):
    params = {"clients": clients, "frames": 16, "best_match_share": share, "query_sets": 64}
    ops = [S.plan(params, i % clients, i // clients)[0] for i in range(16)]
    assert {op: ops.count(op) for op in set(ops)} == expect
    frames = [S.plan(params, i % clients, i // clients)[1] for i in range(16)]
    assert sorted(frames) == list(range(16))  # frames in turn


class FakeClock:
    """Calls complete 0.3 s apart on the device."""

    cuda = False

    def __init__(self):
        self.n = -1

    def mark(self):
        self.n += 1
        return 0.3 * self.n

    def done(self, m):
        return True

    def wait(self, m):
        pass

    def seconds(self, m0, m1):
        return m1 - m0


class FakeStep:
    steps_per_dispatch = 2

    def __init__(self):
        self.calls = 0

    def __call__(self, state, generator):
        self.calls += 1
        return {"loss": torch.tensor([float(self.calls), float("nan") if self.calls == 2 else 1.0])}


def test_training_window_ends_at_the_first_call_past_its_length():
    ctx = types.SimpleNamespace(seconds=1.0, params={"logging_rate": 4},
                                open_window=lambda: None, close_window=lambda: None)
    step = FakeStep()
    seconds, calls, losses = T.window(ctx, None, step, None, FakeClock())
    # calls complete at 0.3, 0.6, 0.9, 1.2: the fourth is the first at or past 1.0
    assert calls == 4 and seconds == pytest.approx(1.2)
    assert len(losses) == 8 and sum(math.isnan(x) for x in losses) == 1


def test_control_readings_are_judged_by_the_cell_limits():
    from portbench import control

    limits = {"match_gap": 1e-4, "dist_err": 1e-4, "failed_requests": 0}
    readings = {"program": {"match_gap": 0.0, "dist_err": 5e-8, "failed_requests": 0.0},
                # the control gives no failure count: it takes the program's
                "control_tf32": {"match_gap": 2.8e-3, "dist_err": 5e-8},
                "fault_half_batch": {"match_gap": 0.0, "dist_err": 5e-8},
                "reference_again": {"match_gap": 9.0, "dist_err": 9.0},
                "losses": {}}
    assert control.judged(readings, limits) == {
        "program": True, "control_tf32": False, "fault_half_batch": True}
