"""The benchmark's files against the rules of ``BENCHMARK.json``, and the rule that a cell,
a configuration or a per-layer metric is added as files alone."""

import json
import re
import shutil

import pytest

from portbench import harness

ROOT, PKG = harness.ROOT, harness.PKG
SPEC = harness.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"] and SPEC["command"] == ["python3", "portbench/run.py"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(SPEC)) <= 64 * 1024
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs)), "a pair of configuration and traffic appears once"


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_load_and_agree(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    files = harness.cell_files(cell)
    wl, cfg = files["workload"], files["config"]
    assert wl["name"] == cell and wl["config"] == entry["config"] == cfg["name"]
    assert wl["traffic"] == entry["traffic"] and wl["why"] == entry["why"]
    mix = harness.load_json(PKG / "traffic" / f"{wl['traffic']}.json")
    assert mix["name"] == wl["traffic"] and wl["driver"] == mix["driver"]
    assert (PKG / "traffic" / f"{mix['driver']}.py").is_file() and entry["chips"] in (1, 4)
    assert wl["limits"], "every cell compares at least one number"
    e2e, layer = harness.cell_metrics(SPEC, cell)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_config_files(config):
    entry = next(c for c in SPEC["configs"] if c["name"] == config)
    cfg = harness.load_json(ROOT / entry["file"])
    assert cfg["name"] == config and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] and cfg["why"] == entry["why"]
    assert any(w["config"] == config for w in SPEC["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_every_per_layer_metric_has_its_reader(metric):
    reader = harness.load_module(PKG / "metrics" / f"{metric}.py", "reader")
    assert reader.read({"config": {}, "workload": {}}) is None  # nothing to read: nothing


def test_a_cell_and_a_metric_are_added_as_files_alone(tmp_path):
    """A dummy configuration, cell and per-layer metric added to a copy of
    the benchmark as new files and entries: the harness finds them by
    name, and no file that was there changed."""
    copy = tmp_path / "portbench"
    shutil.copytree(PKG, copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(copy): p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    cfg = dict(harness.load_json(PKG / "configs" / "resnet34_8s.json"), name="dummy_config")
    (copy / "configs" / "dummy_config.json").write_text(json.dumps(cfg))
    (copy / "traffic" / "dummy.mix.json").write_text(json.dumps(
        {"name": "dummy.mix", "driver": "train", "why": "a test",
         "params": {"batch_size": 2, "steps_per_dispatch": 5, "logging_rate": 10}}))
    (copy / "workloads" / "dummy.cell.json").write_text(json.dumps(
        {"name": "dummy.cell", "config": "dummy_config", "traffic": "dummy.mix", "why": "a test",
         "params": {"logging_rate": 20}, "limits": {"loss_gap": 1.0}}))
    (copy / "metrics" / "dummy.metric.py").write_text(
        "def read(record):\n    return record['steps'] * 2.0\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "dummy_config", "source": "a test",
                            "file": "portbench/configs/dummy_config.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "dummy.cell", "config": "dummy_config",
                              "traffic": "dummy.mix", "chips": 1, "why": "a test"})
    next(m for m in spec["end_to_end"] if m["name"] == "train_pairs_per_s")["workloads"].append(
        "dummy.cell")
    spec["per_layer"].append({"name": "dummy.metric", "unit": "%", "better": "higher",
                              "source": "program_counter", "layer": "a test",
                              "moves": "train_pairs_per_s", "workloads": ["dummy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    files = harness.cell_files("dummy.cell", pkg=copy)
    assert files["config"]["name"] == "dummy_config" and files["workload"]["driver"] == "train"
    assert files["workload"]["params"] == {"batch_size": 2, "steps_per_dispatch": 5,
                                           "logging_rate": 20}  # the cell's own on top
    e2e, layer = harness.cell_metrics(harness.benchmark_spec(tmp_path), "dummy.cell")
    assert {m["name"] for m in e2e} == {"setup_s", "train_pairs_per_s"}
    assert [m["name"] for m in layer] == ["dummy.metric"]
    reader = harness.load_module(copy / "metrics" / "dummy.metric.py", "dummy_reader")
    assert reader.read({"steps": 3}) == 6.0
    after = {p.relative_to(copy): p.read_bytes() for p in copy.rglob("*")
             if p.is_file() and p.relative_to(copy) in before}
    assert after == before


def test_forbidden_modules_compare_whole_names():
    assert harness.forbidden_loaded(["pdc_tpu_torch", "pdc_tpu_torch.ops", "jaxtyping"]) == []
    assert harness.forbidden_loaded(["pdc_tpu.ops", "jax.numpy", "flax"]) == [
        "flax", "jax", "pdc_tpu"]
