"""The benchmark's driver: finds a cell's files by name, runs its traffic
driver once, reads its per-layer metrics and prints the result.

Everything that belongs to one cell, configuration, traffic mix or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

  portbench/workloads/<cell>.json     configuration, traffic mix, the cell's
                                      own parameters, limits of the
                                      correctness check
  portbench/configs/<config>.json     the model configuration as it is run
  portbench/traffic/<traffic>.json    a traffic mix: its driver and the
                                      parameters the driver reads
  portbench/traffic/<driver>.py       ``run(ctx) -> dict`` (a driver)
  portbench/metrics/<metric>.py       ``read(record) -> float | None``

The metrics a run reports are the cell's entries of ``BENCHMARK.json``:
its end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# top-level module names that no process of the benchmark may hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pdc_tpu")


class BenchmarkError(RuntimeError):
    """The run cannot give a result (no card, an unknown cell, a module it
    may not load); it exits non-zero and prints no result."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_module(path: Path, name: str):
    """A module from a file of the benchmark (file names may hold dots)."""
    if not path.is_file():
        raise BenchmarkError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_files(name: str, pkg: Path = PKG) -> dict:
    """A cell's workload, traffic mix and configuration files. The
    workload's ``params`` are the mix's with the cell's own on top, and its
    ``driver`` is the mix's."""
    workload = load_json(pkg / "workloads" / f"{name}.json")
    mix = load_json(pkg / "traffic" / f"{workload['traffic']}.json")
    workload["driver"] = mix["driver"]
    workload["params"] = {**mix.get("params", {}), **workload.get("params", {})}
    config = load_json(pkg / "configs" / f"{workload['config']}.json")
    return {"workload": workload, "config": config}


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(spec: dict, cell: str):
    """``(end_to_end, per_layer)`` entries of ``BENCHMARK.json`` that the
    cell reports. A per-layer metric without ``workloads`` is reported
    wherever the end-to-end metric it moves is."""
    e2e = [m for m in spec["end_to_end"] if applies(m, cell)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if applies(m, cell) and ("workloads" in m or m["moves"] in names)]
    return e2e, layer


def forbidden_loaded(modules=None) -> list:
    """Forbidden top-level module names present in ``sys.modules``,
    compared whole (``pdc_tpu_torch`` is not ``pdc_tpu``)."""
    tops = {name.split(".")[0] for name in (modules if modules is not None else sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def card_line() -> str:
    """The card's name, power limit, SM clock and temperature."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
                              "temperature.gpu", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def device_facts(device, peak_bytes: int) -> dict:
    """The result's ``device`` entry of a run on one card (a CPU run, in the
    tests, says so)."""
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(peak_bytes)}


def require_cards(chips: int):
    """Raise unless CUDA is there with at least ``chips`` cards: a run never
    falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise BenchmarkError("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise BenchmarkError(f"the cell asks for {chips} cards, "
                             f"{torch.cuda.device_count()} present")


class Context:
    """What a traffic driver gets: the cell's files, the run's arguments,
    the device, and hooks that bound the measured window."""

    def __init__(self, cell: str, files: dict, seed: int, seconds: float, trace: bool,
                 device, t_start: float):
        self.cell, self.seed, self.seconds, self.trace = cell, int(seed), float(seconds), trace
        self.workload, self.config = files["workload"], files["config"]
        self.params = self.workload.get("params", {})
        self.limits = self.workload.get("limits", {})
        self.device = device
        self.t_start = t_start
        self.t_window = None
        self.tracer = None

    def phase(self, name: str):
        """Note on standard error that a phase of set-up has ended, with the
        seconds since the process started."""
        print(f"setup: {name} at {time.perf_counter() - self.t_start:.3f} s", file=sys.stderr,
              flush=True)

    def open_window(self):
        """Set-up is over: start the profiler (``--trace 1``), then note the
        host time. Call right before the first timed request or dispatch."""
        if self.trace:
            from portbench.trace import Tracer

            self.tracer = Tracer(self.device)
            self.tracer.start()
        self.t_window = time.perf_counter()

    def close_window(self):
        """The window has ended (the device's work in it included): stop the
        profiler, and note the card's state."""
        if self.tracer is not None:
            self.tracer.stop()
        if self.device.type == "cuda":
            print(f"card after the window: {card_line()}", file=sys.stderr, flush=True)

    @property
    def setup_s(self) -> float:
        return self.t_window - self.t_start


def make_result(ctx: Context, out: dict, e2e: list, layer: list) -> dict:
    """The result line: the metrics of this run's kind, device facts, the
    trace's breakdown, and the compared numbers last."""
    metrics = {}
    if ctx.trace:
        record = dict(out, trace=ctx.tracer.summary() if ctx.tracer else None,
                      workload=ctx.workload, config=ctx.config)
        for m in layer:
            reader = load_module(PKG / "metrics" / f"{m['name']}.py",
                                 "portbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(record)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(out["end_to_end"], setup_s=ctx.setup_s)
        for m in e2e:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    device = dict(out["device"])
    result = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": device}
    if ctx.trace and ctx.tracer is not None:
        summary = ctx.tracer.summary()
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = out["checks"]
    return result


def checks_of(numbers: dict, limits: dict) -> dict:
    """Each limit of the cell beside its number; a number the run could not
    give reads NaN, which fails."""
    return {k: {"value": float(numbers.get(k, math.nan)), "limit": float(v)}
            for k, v in limits.items()}


def judge(checks: dict) -> bool:
    """Every compared number is finite and within its limit."""
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def main(argv, t_start: float) -> int:
    p = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        spec = benchmark_spec()
        cells = {w["name"]: w for w in spec["workloads"]}
        if args.workload not in cells:
            raise BenchmarkError(f"no cell {args.workload!r} in BENCHMARK.json")
        files = cell_files(args.workload)
        e2e, layer = cell_metrics(spec, args.workload)
        require_cards(int(cells[args.workload]["chips"]))
        print(f"card: {card_line()}", flush=True)
        import torch

        # the configurations state float32 without TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        ctx = Context(args.workload, files, args.seed, args.seconds, bool(args.trace), device,
                      t_start)
        traffic = importlib.import_module("portbench.traffic." + files["workload"]["driver"])
        out = traffic.run(ctx)
        result = make_result(ctx, out, e2e, layer)
        bad = forbidden_loaded()
        if bad:
            raise BenchmarkError(f"the run loaded forbidden modules: {', '.join(bad)}")
    except BenchmarkError as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
