"""The port's experiment runner (pdc_tpu_torch.experiments) against
pdc_tpu's, on the CPU.

* The registry equals ``pdc_tpu.experiments.PROTOCOLS`` field for field.
* Each run's training config and synthetic stand-in equal the JAX runner's:
  both runners hand them to a recording stand-in of
  ``DenseCorrespondenceTraining`` / ``SpartanDataset.make_synthetic`` that
  trains and renders nothing. The stand-in frames of two composites are
  then rendered in both packages and compared.
* One smoke protocol trained by the port is scored by both runners (the
  JAX one on a copy of the logging dir, reading the port's model folders).
  The port's sweep is fed the JAX sweep's draws (``sampling.uniform``
  replaced, as in tests/test_torch_port_evaluation.py), so both score the
  same pixels; the two networks agree within 2e-5 of the descriptors'
  scale, so a pick may differ only as a near-tie of the two distances
  (TIE_REL). The ``_STAT_KEYS`` statistics are equal within 1e-6 once the
  tie rows take one side's values; at most 1 pick in 20 may be a tie.
* The rest runs the port alone, at ``Scale.smoke()``: the per-run composite
  grouping, evaluation composites, the per-checkpoint curve and the CLI.
"""

import copy
import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import pdc_tpu.data.dataset as jax_dataset
import pdc_tpu.experiments as jax_exp
import pdc_tpu.experiments.runner as jax_runner
import pdc_tpu.training.train as jax_train
from pdc_tpu_torch import __main__ as cli
from pdc_tpu_torch.data import dataset as port_dataset
from pdc_tpu_torch.data.published_manifest import COMPOSITES
from pdc_tpu_torch.evaluation import evaluate as ev
from pdc_tpu_torch.evaluation.plotting import DenseCorrespondenceEvaluationPlotter as Plotter
from pdc_tpu_torch.evaluation.table import Table, read_csv
from pdc_tpu_torch.experiments import PROTOCOLS, Scale, list_protocols, run_protocol
from pdc_tpu_torch.experiments import runner
from pdc_tpu_torch.ops import sampling
from pdc_tpu_torch.training import train as port_train

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAT_TOL = 1e-6
TIE_REL = 1e-4  # near-tie: the two picks' distances within this share of the larger
MAX_TIE_SHARE = 1 / 20
SWEEP_ATTEMPTS = 2000  # the sweep's padded_num_attempts


@pytest.fixture(autouse=True)
def _free_the_folders(tmp_path):
    """Each smoke run writes ResNet-34-8s checkpoints and Adam states (about
    0.5 GB a run): remove them when the test ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _asdict(p):
    return dataclasses.asdict(p)


def test_registry_equals_jax_field_for_field():
    assert list(PROTOCOLS) == list(jax_exp.PROTOCOLS) and len(PROTOCOLS) == 13
    for name, p in PROTOCOLS.items():
        assert _asdict(p) == _asdict(jax_exp.PROTOCOLS[name]), name
    assert list_protocols() == jax_exp.list_protocols()
    assert runner._STAT_KEYS == jax_runner._STAT_KEYS
    for make in ("full", "smoke"):
        assert _asdict(getattr(Scale, make)()) == _asdict(getattr(jax_exp.Scale, make)())
    # every composite a protocol names exists in configs/ and in the published corpus
    for p in PROTOCOLS.values():
        names = {p.composite} | {r.composite for r in p.runs if r.composite}
        names |= {c for _, c in p.eval_composites}
        for n in names:
            assert os.path.exists(os.path.join(ROOT, "configs", "dataset", "composite", n)), n
            assert n[: -len(".yaml")] in COMPOSITES, n


class _Recorder:
    """Stand-ins for the trainer and the synthetic dataset factory of one
    package: record what the runner hands them, train and render nothing."""

    def __init__(self, real_trainer):
        self.configs, self.synthetic = [], []
        rec = self

        class Trainer:
            load_default_config = staticmethod(real_trainer.load_default_config)

            def __init__(self, config=None, dataset=None, device=None):
                rec.configs.append(copy.deepcopy(config))
                self._t = config["training"]

            def run(self):
                return os.path.join(self._t["logging_dir"], self._t["logging_dir_name"])
        self.Trainer = Trainer

    def make_synthetic(self, **kwargs):
        self.synthetic.append(dict(kwargs))
        return ("synthetic", len(self.synthetic))


@pytest.mark.parametrize("name,scale", [(n, "smoke") for n in PROTOCOLS]
                         + [("caterpillar", "full")])
def test_training_configs_equal_jax(name, scale, tmp_path, monkeypatch):
    port, jax_rec = (_Recorder(port_train.DenseCorrespondenceTraining),
                     _Recorder(jax_train.DenseCorrespondenceTraining))
    monkeypatch.setattr(port_train, "DenseCorrespondenceTraining", port.Trainer)
    monkeypatch.setattr(jax_train, "DenseCorrespondenceTraining", jax_rec.Trainer)
    monkeypatch.setattr(port_dataset.SpartanDataset, "make_synthetic",
                        staticmethod(port.make_synthetic))
    monkeypatch.setattr(jax_dataset.SpartanDataset, "make_synthetic",
                        staticmethod(jax_rec.make_synthetic))
    logging_dir = str(tmp_path / name)
    got = run_protocol(name, scale=getattr(Scale, scale)(), logging_dir=logging_dir,
                       evaluate=False, device="cpu")
    want = jax_exp.run_protocol(name, scale=getattr(jax_exp.Scale, scale)(),
                                logging_dir=logging_dir, evaluate=False)
    assert len(port.configs) == len(PROTOCOLS[name].runs) > 0
    assert port.configs == jax_rec.configs
    assert port.synthetic == jax_rec.synthetic and port.synthetic
    assert got == want
    assert json.load(open(os.path.join(logging_dir, "result.json"))) == json.loads(
        json.dumps(want, default=float))
    if scale == "full":
        net = port.configs[0]["dense_correspondence_network"]
        assert (net["image_width"], net["image_height"]) == (640, 480)
        assert net["backbone"]["resnet_name"] == "Resnet34_8s"
        assert port.configs[0]["training"]["num_iterations"] == 3500


@pytest.mark.parametrize("composite", ["caterpillar_only.yaml",
                                       "caterpillar_baymax_starbot_all_front.yaml"])
def test_synthetic_stand_in_frames_equal_jax(composite):
    protocol = PROTOCOLS["multi_object"]
    scale = Scale.smoke()
    ds = runner._resolve_dataset(protocol, composite, None, None, scale, {})
    jds = jax_runner._resolve_dataset(jax_exp.PROTOCOLS["multi_object"], composite, None, None,
                                      jax_exp.Scale.smoke(), {})
    assert ds.config == jds.config and ds.config["synthetic"]["seed_offset"] > 0
    for mode in ("train", "test"):
        ds.mode = jds.mode = mode
        assert sorted(ds.scenes) == sorted(jds.scenes) and ds.scenes
        for n, s in ds.scenes.items():
            j = jds.scenes[n]
            assert s.object_id == j.object_id
            for k in ("rgb", "depth", "mask", "poses"):
                np.testing.assert_array_equal(getattr(s, k), np.asarray(getattr(j, k)),
                                              err_msg=f"{mode} {n} {k}")


class _JaxSweepDraws:
    """Stand-in for ``sampling.uniform``: a sweep generator (seeded with a
    pair seed of :func:`ev.pair_seed` at seed 1) gets the uniform draws the
    JAX sweep makes for that pair; every other call is the real one."""

    def __init__(self, n_pairs):
        key, self.by_seed = jax.random.PRNGKey(1), {}
        for p in range(n_pairs):
            key, sub = jax.random.split(key)
            k_sample, _ = jax.random.split(sub)
            self.by_seed[ev.pair_seed(1, p)] = np.asarray(
                jax.random.uniform(k_sample, (SWEEP_ATTEMPTS,)))
        self.real, self.served = sampling.uniform, 0

    def __call__(self, shape, generator, device=None, dtype=torch.float32):
        u = self.by_seed.get(generator.initial_seed())
        if u is None:
            return self.real(shape, generator, device, dtype)
        assert tuple(shape) == u.shape
        self.served += 1
        return torch.as_tensor(u, dtype=dtype, device=device)


def _tie_rows(port_csv, jax_csv):
    """The two runners' tables of one network, row for row (the same pair
    and ground truth), and the rows where they picked different pixels (the
    pixel error differs); each such pick must be a near-tie of the two
    distances. Returns (tie mask, port table, JAX frame)."""
    import pandas as pd

    p = read_csv(port_csv)
    j = pd.read_csv(jax_csv, index_col=0)
    assert list(p.columns) == list(j.columns) and len(p) == len(j) > 0
    for c in ("scene_name", "img_a_idx", "img_b_idx"):
        assert list(p[c]) == list(j[c]), c
    np.testing.assert_allclose(p["norm_diff_ground_truth_3d"].astype(np.float64),
                               j["norm_diff_ground_truth_3d"].to_numpy(np.float64), rtol=1e-5,
                               atol=1e-6)
    differ = np.abs(p["pixel_match_error_l2"].astype(np.float64)
                    - j["pixel_match_error_l2"].to_numpy(np.float64)) > 1e-3
    dp = p["norm_diff_descriptor"].astype(np.float64)
    dj = j["norm_diff_descriptor"].to_numpy(np.float64)
    near = np.abs(dp - dj) <= TIE_REL * np.maximum(np.maximum(dp, dj), 1e-3)
    assert near[differ].all(), (dp[differ], dj[differ])
    return differ, p, j


def test_smoke_protocol_trained_by_the_port_scored_by_both_runners(tmp_path, monkeypatch):
    scale = Scale.smoke()
    draws = _JaxSweepDraws(scale.num_eval_pairs)
    monkeypatch.setattr(sampling, "uniform", draws)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    kw = dict(run_filter="^baymax_standard", seeds=2)
    got = run_protocol("domain_randomization", scale=scale, logging_dir=port_dir,
                       device="cpu", **kw)
    assert draws.served == 2 * scale.num_eval_pairs  # both networks' sweeps
    nets = ["baymax_standard_3__seed1", "baymax_standard_3__seed2"]
    assert list(got["networks"]) == nets
    assert {got["networks"][n]["overrides"]["training.seed"] for n in nets} == {1, 2}
    for n in nets:
        assert os.path.exists(os.path.join(port_dir, n, "000004.ckpt"))

    shutil.copytree(port_dir, jax_dir, ignore=shutil.ignore_patterns("*.opt"))
    for n in nets:  # the JAX runner reads the port's folders, and scores them afresh
        shutil.rmtree(os.path.join(jax_dir, n, "test"))
    want = jax_exp.run_protocol("domain_randomization", scale=jax_exp.Scale.smoke(),
                                logging_dir=jax_dir, train=False, **kw)
    port_json = json.load(open(os.path.join(port_dir, "result.json")))
    jax_json = json.load(open(os.path.join(jax_dir, "result.json")))
    assert set(port_json) == set(jax_json)
    assert set(port_json["seed_aggregates"]) == set(jax_json["seed_aggregates"]) == {
        "baymax_standard_3"}
    total = ties = 0
    for n in nets:
        assert set(port_json["networks"][n]) == set(jax_json["networks"][n])
        differ, p, j = _tie_rows(os.path.join(port_dir, n, "test", "data.csv"),
                                 os.path.join(jax_dir, n, "test", "data.csv"))
        total += len(differ)
        ties += int(differ.sum())
        # the tie rows take the JAX values: then every statistic is equal
        rows = p.rows()
        for i in np.nonzero(differ)[0]:
            for c in ("pixel_match_error_l2", "norm_diff_pred_3d"):
                rows[i][c] = float(j[c].iloc[i])
        stats = Plotter.run_on_single_dataframe(None, dataframe=Table.from_rows(
            rows, list(p.columns)), save=False)
        for k in runner._STAT_KEYS:
            w = want["networks"][n]["test"][k]
            assert abs(stats[k] - w) <= STAT_TOL, (n, k, stats[k], w)
            if not differ.any():
                assert abs(got["networks"][n]["test"][k] - w) <= STAT_TOL, (n, k)
            assert 0.0 <= got["networks"][n]["test"][k] <= (1.0 if "pck" in k else np.inf)
    assert ties <= MAX_TIE_SHARE * total, (ties, total)


def test_run_filter_unmatched_and_unknown_protocol_raise(tmp_path):
    with pytest.raises(ValueError, match="matched no runs"):
        run_protocol("domain_randomization", scale=Scale.smoke(), run_filter="no_such_run",
                     logging_dir=str(tmp_path / "x"), device="cpu")
    assert not (tmp_path / "x").exists()
    with pytest.raises(KeyError, match="unknown protocol"):
        run_protocol("no_such_protocol", device="cpu")


def test_benchmark_groups_by_run_composite_no_eval_then_eval_only(tmp_path, capsys):
    """``--no_eval`` trains the two runs (each on its own composite), then
    ``--eval_only`` scores them, each on its own composite's test split."""
    logging_dir = str(tmp_path / "b")
    base = ["experiment", "benchmark", "--smoke", "--device", "cpu", "--logging_dir",
            logging_dir]
    assert cli.main(base + ["--no_eval"]) == 0
    assert capsys.readouterr().out.count("training") == 2
    trained = json.load(open(os.path.join(logging_dir, "result.json")))
    assert all("test" not in info for info in trained["networks"].values())
    assert not os.path.exists(os.path.join(logging_dir, "comparison_test.yaml"))
    assert cli.main(base + ["--eval_only"]) == 0
    assert "training" not in capsys.readouterr().out
    nets = json.load(open(os.path.join(logging_dir, "result.json")))["networks"]
    assert nets["cbs_3"]["test_composite"] == (
        "caterpillar_baymax_starbot_all_front_single_only.yaml")
    assert nets["shoes_consistent_3"]["test_composite"] == "shoe_train_all_shoes.yaml"
    for info in nets.values():
        assert set(info["test"]) == set(runner._STAT_KEYS)
    files = set(os.listdir(logging_dir))
    assert {"comparison_test.yaml", "comparison_test_shoe_train_all_shoes.yaml"} <= files
    # resume: a rerun with training retrains nothing
    assert cli.main(base + ["--no_eval"]) == 0
    assert capsys.readouterr().out.count("already trained") == 2


def test_multi_object_truncated_gets_both_eval_composites(tmp_path):
    summary = run_protocol("multi_object", scale=Scale.smoke(), max_runs=1,
                           logging_dir=str(tmp_path / "mo"), device="cpu")
    assert summary["runs_truncated"] == 23
    (name, info), = summary["networks"].items()
    for key in ("analysis_isolated_scene", "analysis_cluttered_scene"):
        assert set(info[key]) == set(runner._STAT_KEYS), key
        assert os.path.exists(os.path.join(str(tmp_path / "mo"), name, key, "stats.yaml"))


def test_training_steps_curve_scores_every_checkpoint(tmp_path):
    """``--steps 4 --save_rate 2``: the run's own ``training.save_rate:
    1000`` wins over the scale's, as in pdc_tpu, so the folder holds the
    checkpoints of steps 0 and 4, and the curve scores each."""
    scale = Scale.smoke()
    scale.steps, scale.save_rate = 4, 2
    summary = run_protocol("caterpillar_training_steps", scale=scale,
                           logging_dir=str(tmp_path / "ts"), device="cpu")
    (info,) = summary["networks"].values()
    curve = info["pck_vs_steps"]
    assert runner._checkpoint_iterations(info["model_folder"]) == sorted(curve) == [0, 4]
    for it, stats in curve.items():
        assert set(stats) == set(runner._STAT_KEYS), it
        assert os.path.exists(os.path.join(info["model_folder"], f"analysis_iter_{it:06d}",
                                           "data.csv"))
    # the JSON keys of the curve are strings, as the JAX runner writes them
    written = json.load(open(os.path.join(str(tmp_path / "ts"), "result.json")))
    assert sorted(next(iter(written["networks"].values()))["pck_vs_steps"]) == ["0", "4"]


def test_cli_list_smoke_presets_and_cuda_default(monkeypatch, capsys, tmp_path):
    assert cli.main(["experiment", "--list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == list(PROTOCOLS)
    assert cli.main(["experiment"]) == 0  # no protocol: the list
    assert len(capsys.readouterr().out.splitlines()) == 13
    seen = {}

    def fake_run(name, **kw):
        seen.update(kw, name=name)
    monkeypatch.setattr("pdc_tpu_torch.experiments.run_protocol", fake_run)
    assert cli.main(["experiment", "caterpillar", "--smoke", "--steps", "3", "--width", "96",
                     "--seeds", "2", "--run_filter", "0.500", "--max_runs", "1",
                     "--device", "cpu"]) == 0
    s = seen["scale"]
    assert (s.steps, s.width, s.height, s.batch_size, s.num_eval_pairs) == (3, 96, 48, 2, 2)
    assert s.extra_overrides == Scale.smoke().extra_overrides
    assert (seen["seeds"], seen["run_filter"], seen["max_runs"], seen["device"],
            seen["train"], seen["evaluate"]) == (2, "0.500", 1, "cpu", True, True)
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert cli.main(["experiment", "caterpillar"]) == 0
    assert seen["scale"] == Scale.full() and seen["device"] == "cuda"
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["experiment", "domain_randomization", "--smoke", "--logging_dir",
                  str(tmp_path / "never")])
    assert not (tmp_path / "never").exists()
