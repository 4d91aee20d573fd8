"""The benchmark's device trace: ``torch.profiler`` over the measured window
of a ``--trace 1`` run, reduced to what the per-layer metrics read.

The profiler records the host's torch operations and the device's kernels,
copies and fills (CUPTI; a CUDA graph's replays included). The trace goes
to a file under ``TMPDIR``, is read back and deleted. Its reduction:

- ``window_s``: the window, from the ``portbench.window`` range that
  :meth:`Tracer.start` opens to :meth:`Tracer.stop`;
- ``busy_s``: the union of the device's intervals (kernels, copies,
  fills) inside the window;
- ``device_ops``: device seconds by kernel name, the ten largest;
- ``idle_gaps``: the device's idle time inside the window by what the host
  was doing when each gap began (the innermost host event then running,
  on any thread, with its parent), the ten largest; gaps shorter than
  :data:`SHORT_GAP_US` are summed under one name;
- ``kernels``: ``(name, start_us, duration_us, grid)`` of every kernel
  inside the window, for the readers of single kernels.
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW_NAME = "portbench.window"
SHORT_GAP_US = 20.0
TOP = 10


class Tracer:
    def __init__(self, device):
        self.device = device
        self._summary = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        self._range = record_function(WINDOW_NAME)
        self._range.__enter__()
        self._torch = torch

    def stop(self):
        self._range.__exit__(None, None, None)
        self._torch.cuda.synchronize(self.device)
        self._prof.stop()
        fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self._prof = None
        self._summary = reduce_trace(events)

    def summary(self) -> dict:
        return self._summary


def _union(intervals):
    """Merged ``[(start, end)]`` of intervals sorted by start."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _host_labels(host, times):
    """For each of the sorted ``times``, the innermost host event running
    then on any thread (the latest started), as ``"parent > event"``, or
    None. ``host``: ``(start, end, thread, name)`` sorted by start; a
    thread's events nest."""
    stacks = defaultdict(list)  # thread -> [(end, start, name)] outermost first
    labels, i = [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            s, e, tid, name = host[i]
            st = stacks[tid]
            while st and st[-1][0] <= s:
                st.pop()
            st.append((e, s, name))
            i += 1
        best = None
        for st in stacks.values():
            while st and st[-1][0] <= t:
                st.pop()
            if st and (best is None or st[-1][1] > best[-1][1]):
                best = st
        if best is None:
            labels.append(None)
        else:
            labels.append(best[-1][2] if len(best) < 2
                          else f"{best[-2][2]} > {best[-1][2]}")
    return labels


def reduce_trace(events) -> dict:
    window = [e for e in events if e.get("name") == WINDOW_NAME
              and e.get("cat") == "user_annotation" and "dur" in e]
    if not window:
        raise RuntimeError("the trace has no window range")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    device, kernels, by_name = [], [], defaultdict(float)
    host = []
    for e in events:
        if "dur" not in e or e.get("ph") != "X":
            continue
        cat = e.get("cat")
        s = float(e["ts"])
        end = s + float(e["dur"])
        if cat in DEVICE_CATS:
            s, end = max(s, w0), min(end, w1)
            if end <= s:
                continue
            device.append((s, end))
            by_name[e["name"]] += end - s
            if cat == "kernel":
                kernels.append((e["name"], s, end - s, tuple(e.get("args", {}).get("grid", ()))))
        elif cat in HOST_CATS and e.get("name") != WINDOW_NAME:
            host.append((s, end, e.get("tid"), e["name"]))
    device.sort()
    busy = _union(device)
    busy_us = sum(e - s for s, e in busy)
    gaps, t = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            gaps.append((t, s - t))
        t = max(t, e)
    long_gaps = [g for g in gaps if g[1] >= SHORT_GAP_US]
    host.sort()
    labels = _host_labels(host, [g[0] for g in long_gaps])
    by_label = defaultdict(float)
    for (_, d), label in zip(long_gaps, labels):
        by_label[label or "no torch operation on the host"] += d
    short = sum(d for _, d in gaps if d < SHORT_GAP_US)
    if short:
        by_label[f"gaps under {SHORT_GAP_US:g} us between device operations"] += short
    top = heapq.nlargest(TOP, by_name.items(), key=lambda kv: kv[1])
    idle = heapq.nlargest(TOP, by_label.items(), key=lambda kv: kv[1])
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "device_ops": [[n, v * 1e-6] for n, v in top],
        "idle_gaps": [[n, v * 1e-6] for n, v in idle],
        "kernels": kernels,
    }
