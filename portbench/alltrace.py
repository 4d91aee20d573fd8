"""A serve cell's traced run under a profiler that records every thread, and
the device's idle time in its window put down to the descriptor server's
spans:

    python3 portbench/alltrace.py --workload <serve cell> --seed <n> [--seconds 10] [--main-thread]

from the root of a checkout, on the card. It prints what ``run.py --trace 1``
prints, then one line ``ALLTRACE {...}`` with:

- ``idle_by_batcher_span_s``: the window's idle seconds by the batcher's
  span open then (``serve.starved`` ... ``serve.fanout``), or, between its
  spans, by the span that ended last; ``idle_by_batcher_and_handler_s`` the
  same, split by the handlers' state (in ``serve.reply``, else in
  ``serve.read``, else in ``serve.wait``, else none); ``unlabelled_s``, the
  idle time that no server span covers;
- ``window_stats``: the delta of the server's ``stats`` from the moment the
  profiler has started to the window's end, so over the window alone, with
  ``window_ms_per_dispatch`` and ``window_ms_per_frame`` of its phases and
  ``phases_over_window``, the six batcher phases' sum over the window;
- ``profiler_start_s``: how long the profiler took to start;
- ``end_to_end``: the run's end-to-end numbers under the profiler.

``portbench/trace.py`` records the host's operations of the main thread only,
and the server does its work on other threads, so its spans never reach the
benchmark's ``idle_gaps``. This tool turns the profiler to every thread
(``_ExperimentalConfig(profile_all_threads=True)``) in its own process only,
by wrapping :class:`portbench.trace.Tracer`, and reads the spans from the
trace's events. ``--main-thread`` keeps the benchmark's profiler, for the
cost of recording every thread.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from contextlib import contextmanager

import numpy as np

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BATCHER = ("serve.starved", "serve.gather", "serve.assemble", "serve.upload", "serve.launch",
           "serve.device_wait", "serve.download", "serve.fanout")
HANDLER = ("serve.wait", "serve.read", "serve.reply")  # a later one wins where both are open
PHASES = ("starved_s", "gather_s", "upload_s", "device_wait_s", "download_s", "batcher_host_s")


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _inside(intervals, t):
    """For each of the times ``t``, whether it lies in the sorted, disjoint
    ``intervals``."""
    if not intervals:
        return np.zeros(len(t), bool)
    iv = np.asarray(intervals, float)
    i = np.searchsorted(iv[:, 0], t, side="right") - 1
    return (i >= 0) & (t < iv[np.maximum(i, 0), 1])


def analyse(events, window_name: str) -> dict:
    """The device's idle time inside the range ``window_name`` of a chrome
    trace's ``events``, by the server's spans (see the module docstring)."""
    from portbench.trace import DEVICE_CATS

    w = next(e for e in events if e.get("name") == window_name and "dur" in e)
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    busy = _union([(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1))
                   for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
                   and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0])
    gaps, t = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and str(e.get("name")).startswith("serve.") \
                and "dur" in e:
            spans.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    unions = {n: _union(v) for n, v in spans.items()}
    # cut the idle time at every edge of a gap or a span
    points = np.unique(np.array([p for g in gaps for p in g]
                                + [p for iv in unions.values() for s in iv for p in s], float))
    points = points[(points >= w0) & (points <= w1)]
    a, b = points[:-1], points[1:]
    mid = 0.5 * (a + b)
    keep = _inside(_union(gaps), mid)
    a, b, mid = a[keep], b[keep], mid[keep]
    batcher = np.full(len(mid), "", dtype=object)
    for n in BATCHER:
        if n in unions:
            batcher[_inside(unions[n], mid)] = n
    ends = sorted((e, n) for n in BATCHER for _, e in spans.get(n, []))
    between = batcher == ""
    if ends:
        last = np.searchsorted(np.array([e for e, _ in ends]), mid[between], side="right") - 1
        batcher[between] = [f"after {ends[i][1]}" if i >= 0 else "before any span"
                            for i in last]
    handler = np.full(len(mid), "no handler span", dtype=object)
    for n in HANDLER:
        if n in unions:
            handler[_inside(unions[n], mid)] = n
    unlabelled = between & (handler == "no handler span")
    by_span, by_both = {}, {}
    for bp, hs, d in zip(batcher, handler, b - a):
        by_span[bp] = by_span.get(bp, 0.0) + 1e-6 * d
        by_both[f"{bp} | {hs}"] = by_both.get(f"{bp} | {hs}", 0.0) + 1e-6 * d

    def ranked(d):
        return dict(sorted(d.items(), key=lambda kv: -kv[1]))

    return {"window_s": 1e-6 * (w1 - w0), "busy_s": 1e-6 * sum(e - s for s, e in busy),
            "idle_s": 1e-6 * float((b - a).sum()),
            "unlabelled_s": 1e-6 * float((b - a)[unlabelled].sum()),
            "idle_by_batcher_span_s": ranked(by_span),
            "idle_by_batcher_and_handler_s": ranked(by_both),
            "span_counts": {n: len(v) for n, v in spans.items()}}


@contextmanager
def recording(all_threads: bool = True):
    """Within: the benchmark's profiler records every thread (or the main
    thread alone), and the run's server, window-edge ``stats``, trace events
    and end-to-end numbers go into the dict yielded."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import pdc_tpu_torch.apps.serve as serve
    from portbench import harness, trace

    got = {}
    real = (serve.DescriptorServer.__init__, trace.Tracer.start, trace.Tracer.stop,
            trace.reduce_trace, harness.make_result)

    def init(self, *args, **kwargs):
        real[0](self, *args, **kwargs)
        got["server"] = self

    def start(self):
        kwargs = {}
        if all_threads:
            from torch._C._profiler import _ExperimentalConfig

            kwargs["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
        t = time.perf_counter()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **kwargs)
        self._prof.start()
        got["profiler_start_s"] = time.perf_counter() - t
        self._range = record_function(trace.WINDOW_NAME)
        self._range.__enter__()
        self._torch = torch
        if "server" in got:
            got["stats_open"], got["t_open"] = dict(got["server"].stats), time.perf_counter()

    def stop(self):
        if "server" in got:
            got["stats_close"], got["t_close"] = dict(got["server"].stats), time.perf_counter()
        real[2](self)

    def reduce_trace(events):
        got["events"] = events
        return real[3](events)

    def make_result(ctx, out, e2e, layer):
        got["end_to_end"] = out.get("end_to_end")
        return real[4](ctx, out, e2e, layer)

    serve.DescriptorServer.__init__, trace.Tracer.start, trace.Tracer.stop = init, start, stop
    trace.reduce_trace, harness.make_result = reduce_trace, make_result
    try:
        yield got
    finally:
        (serve.DescriptorServer.__init__, trace.Tracer.start, trace.Tracer.stop,
         trace.reduce_trace, harness.make_result) = real


def summary(got: dict) -> dict:
    """The ``ALLTRACE`` line's numbers of what :func:`recording` caught."""
    from portbench.trace import WINDOW_NAME

    out = {k: got.get(k) for k in ("profiler_start_s", "end_to_end")}
    a, b = got.get("stats_open"), got.get("stats_close")
    if a and b:
        d = {k: b[k] - a[k] for k in b}
        host_s = got["t_close"] - got["t_open"]
        out.update(window_stats=d, window_host_s=host_s)
        if d.get("dispatches") and all(k in d for k in PHASES):
            out["window_ms_per_dispatch"] = {k: 1e3 * d[k] / d["dispatches"] for k in PHASES}
            out["phases_over_window"] = sum(d[k] for k in PHASES) / host_s
        if d.get("frames") and "handler_s" in d:
            out["window_ms_per_frame"] = {k: 1e3 * d[k] / d["frames"]
                                          for k in ("queue_wait_s", "handler_s")}
    if "events" in got:
        out["analysis"] = analyse(got["events"], WINDOW_NAME)
    return out


def main() -> int:
    p = argparse.ArgumentParser(prog="portbench/alltrace.py", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--main-thread", action="store_true",
                   help="the benchmark's own profiler, of the main thread only")
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    from portbench import harness
    from portbench.run import CACHES

    os.environ.update(CACHES)
    with recording(all_threads=not args.main_thread) as got:
        rc = harness.main(["--workload", args.workload, "--seed", str(args.seed),
                           "--seconds", str(args.seconds), "--trace", "1"], T_START)
    line = dict(workload=args.workload, seed=args.seed, all_threads=not args.main_thread,
                rc=rc, **summary(got))
    print("ALLTRACE " + json.dumps(line), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
