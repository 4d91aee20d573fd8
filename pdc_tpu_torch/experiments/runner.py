"""Headless runner of the reference's experiment protocols.

Port of :mod:`pdc_tpu.experiments.runner`: ``_STAT_KEYS`` (:28), ``Scale``
(:32), ``set_nested`` (:68), ``_resolve_dataset`` (:76),
``_checkpoint_iterations`` (:116), ``_quantitative_stats`` (:127) and
``run_protocol`` (:149). It runs any protocol of
:mod:`pdc_tpu_torch.experiments.protocols` end to end: resolve the dataset
(the composite under ``data_dir`` when given, else a synthetic stand-in),
train every variant with
:class:`~pdc_tpu_torch.training.train.DenseCorrespondenceTraining`, score
every network with the evaluation registry
(:class:`~pdc_tpu_torch.evaluation.evaluate.DenseCorrespondenceEvaluation`,
``comparison_test[_<composite>].yaml``, and its CDF overlay ``.png`` where
matplotlib imports), and write ``result.json`` with the JAX runner's keys.

Everything runs on ``device`` (default ``"cuda"``; it raises without CUDA
unless ``"cpu"`` is asked for). On the card each train step launches the
pooled-hinge kernels (K1, K2) and each sweep chunk the best-match kernel
(K3).
"""

from __future__ import annotations

import copy
import dataclasses
import glob
import json
import os
import re
import zlib
from typing import Dict, Optional

from pdc_tpu_torch.experiments.protocols import PROTOCOLS, Protocol, Run

_STAT_KEYS = ("pck_at_5px", "pck_at_10px", "norm_diff_3d_area_above_curve")
_COMPOSITE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "dataset", "composite")


@dataclasses.dataclass
class Scale:
    """Compute-scale knobs. A protocol's shape (variant grid, config
    changes, dataset structure) is fixed; these only size the compute.
    ``full()`` is the notebooks' setting; ``smoke()`` a CI-sized run."""

    steps: Optional[int] = None      # None -> protocol.num_iterations
    width: int = 640
    height: int = 480
    batch_size: Optional[int] = None
    num_eval_pairs: int = 100
    num_matches_per_pair: int = 100
    save_rate: Optional[int] = None  # None -> one checkpoint at the end
    # dotted-key training-config overrides applied to EVERY run (smoke
    # shrinks the sampling and pool sizes, which the 640x480 defaults make
    # dominate a tiny CPU run)
    extra_overrides: Optional[Dict[str, object]] = None

    @classmethod
    def full(cls):
        return cls()

    @classmethod
    def smoke(cls):
        return cls(steps=4, width=64, height=48, batch_size=2,
                   num_eval_pairs=2, num_matches_per_pair=10,
                   extra_overrides={
                       "training.num_matching_attempts": 256,
                       "training.num_non_matches_per_match": 10,
                       "training.masked_pool_size": 64,
                       "training.background_pool_size": 64,
                       "training.num_blind_samples": 64,
                       "training.steps_per_dispatch": 2,
                   })


def set_nested(cfg: dict, dotted_key: str, value):
    d = cfg
    parts = dotted_key.split(".")
    for p in parts[:-1]:
        d = d.setdefault(p, {})
    d[parts[-1]] = value


def _resolve_dataset(protocol: Protocol, composite: Optional[str], data_dir: Optional[str],
                     dataset_dir: Optional[str], scale: Scale, cache: dict):
    """The SpartanDataset of ``composite`` (or the protocol's): the
    composite config under ``dataset_dir`` (default
    ``configs/dataset/composite``) over the scenes of ``data_dir`` when
    given, else the protocol's synthetic stand-in. One instance per
    composite name, so distinct evaluation sets stay distinct objects."""
    from pdc_tpu_torch.data.dataset import SpartanDataset

    name = composite or protocol.composite
    if name in cache:
        return cache[name]
    if data_dir:
        from pdc_tpu_torch.utils.yaml_io import load_yaml

        path = name if os.path.isabs(name) else os.path.join(dataset_dir or _COMPOSITE_DIR, name)
        ds = SpartanDataset(config=load_yaml(path), data_dir=data_dir,
                            config_dir=os.path.dirname(path))
    else:
        kw = dict(protocol.synthetic)
        kw["width"], kw["height"] = scale.width, scale.height
        # distinct composites get distinct scene seeds (same objects and
        # textures): the cluttered evaluation set is other scenes, not the
        # training set under another name. crc32 stepped by 1000 clears the
        # test scenes' seed band; offsets stay below 2^31
        kw["seed_offset"] = (zlib.crc32(name.encode()) % (2 ** 21)) * 1000
        ds = SpartanDataset.make_synthetic(**kw)
    cache[name] = ds
    return ds


def _checkpoint_iterations(model_folder: str):
    its = []
    for p in glob.glob(os.path.join(model_folder, "*.ckpt")):
        # %06d pads but does not truncate: 1e6 steps and more have 7+ digits
        m = re.match(r"^(\d{6,})\.ckpt$", os.path.basename(p))
        if m:
            its.append(int(m.group(1)))
    return sorted(its)


def _quantitative_stats(dcn, dataset, out_dir: str, label: str, scale: Scale):
    """The quantitative table (``data.csv``) and ``stats.yaml`` of one
    network on one dataset, under ``out_dir``; returns the ``_STAT_KEYS``
    statistics ({} when the sweep found no match)."""
    from pdc_tpu_torch.evaluation.evaluate import DenseCorrespondenceEvaluation as DCE
    from pdc_tpu_torch.evaluation.plotting import DenseCorrespondenceEvaluationPlotter as DCEP

    os.makedirs(out_dir, exist_ok=True)
    table = DCE.evaluate_network_quantitative(
        dcn, dataset, num_image_pairs=scale.num_eval_pairs,
        num_matches_per_image_pair=scale.num_matches_per_pair)
    csv_path = os.path.join(out_dir, "data.csv")
    table.to_csv(csv_path)
    if not len(table):
        return {}
    stats = DCEP.run_on_single_dataframe(csv_path, label=label, output_dir=out_dir, save=True)
    return {k: stats[k] for k in _STAT_KEYS if k in stats}


def _expand_runs(protocol: Protocol, run_filter: Optional[str], max_runs: Optional[int],
                 seeds: int):
    """The runs selected by ``run_filter`` and ``max_runs``, each replicated
    under ``seeds`` training seeds; returns (runs, number truncated)."""
    runs = list(protocol.runs)
    if run_filter:
        runs = [r for r in runs if re.search(run_filter, r.name)]
        if not runs:
            raise ValueError(f"run_filter {run_filter!r} matched no runs of {protocol.name!r}")
    truncated = 0
    if max_runs is not None and len(runs) > max_runs:
        truncated = len(runs) - max_runs
        runs = runs[:max_runs]
    if seeds > 1:
        runs = [Run(name=f"{r.name}__seed{sv}", overrides={**r.overrides, "training.seed": sv},
                    composite=r.composite)
                for r in runs for sv in range(1, seeds + 1)]
    return runs, truncated


def _training_config(default: dict, run: Run, scale: Scale, protocol: Protocol,
                     logging_dir: str) -> dict:
    cfg = copy.deepcopy(default)
    t = cfg["training"]
    steps = scale.steps or protocol.num_iterations
    t["num_iterations"] = steps
    t["logging_dir"] = logging_dir
    t["logging_dir_name"] = run.name
    t["save_rate"] = scale.save_rate or max(steps, 1)
    t["logging_rate"] = max(steps // 10, 1)
    if scale.batch_size:
        t["batch_size"] = scale.batch_size
    net = cfg["dense_correspondence_network"]
    net["image_width"], net["image_height"] = scale.width, scale.height
    for k, v in (scale.extra_overrides or {}).items():
        set_nested(cfg, k, v)
    for k, v in run.overrides.items():
        set_nested(cfg, k, v)
    return cfg


def _seed_aggregates(networks: dict) -> dict:
    """Cross-seed mean/min/max/spread of every ``_STAT_KEYS`` statistic of
    every scored dataset ("test" and any evaluation composite), per
    variant."""
    agg: Dict[str, dict] = {}
    for n, info in networks.items():
        m = re.match(r"^(.*)__seed(\d+)$", n)
        if not m:
            continue
        for key, stats in info.items():
            if not (isinstance(stats, dict) and any(k in stats for k in _STAT_KEYS)):
                continue
            for k in _STAT_KEYS:
                if k in stats:
                    (agg.setdefault(m.group(1), {}).setdefault(key, {})
                     .setdefault(k, []).append(float(stats[k])))
    return {base: {key: {k: {"mean": sum(vs) / len(vs), "min": min(vs), "max": max(vs),
                             "spread": max(vs) - min(vs), "n": len(vs)}
                         for k, vs in ks.items()}
                   for key, ks in keys.items()}
            for base, keys in agg.items()}


def run_protocol(name: str, scale: Optional[Scale] = None, data_dir: Optional[str] = None,
                 dataset_dir: Optional[str] = None, logging_dir: Optional[str] = None,
                 train: bool = True, evaluate: bool = True, max_runs: Optional[int] = None,
                 run_filter: Optional[str] = None, seeds: int = 1, device="cuda"):
    """Execute one protocol; returns the summary dict, also written to
    ``<logging_dir>/result.json``.

    A run whose final checkpoint exists is not trained again (resume).
    Networks are scored grouped by their own train composite: a group other
    than the protocol's writes ``comparison_test_<composite>.yaml``.

    :param max_runs: truncate the variant grid; the summary records how many
        runs were cut
    :param run_filter: regex selecting runs by name
    :param seeds: replicate every selected run under ``training.seed`` =
        1..N (names suffixed ``__seed<N>``); the summary gains per-variant
        ``seed_aggregates``. The evaluation sets are seed-independent, so the
        spread is training variance only
    :param device: where every run trains and every network is scored
    """
    if name not in PROTOCOLS:
        raise KeyError(f"unknown protocol {name!r}; have {sorted(PROTOCOLS)}")
    from pdc_tpu_torch.utils.device import resolve_device

    protocol = PROTOCOLS[name]
    device = resolve_device(device)  # before any folder or dataset is made
    scale = scale or Scale.full()
    logging_dir = logging_dir or os.path.join("trained_models", "experiments", name)

    from pdc_tpu_torch.evaluation.evaluate import DenseCorrespondenceEvaluation as DCE
    from pdc_tpu_torch.models.dcn import DenseCorrespondenceNetwork
    from pdc_tpu_torch.training.train import DenseCorrespondenceTraining

    runs, truncated = _expand_runs(protocol, run_filter, max_runs, seeds)
    os.makedirs(logging_dir, exist_ok=True)
    ds_cache: dict = {}
    summary = {
        "protocol": name,
        "reference_dir": "dense_correspondence/experiments/" + protocol.reference_dir,
        "description": protocol.description,
        "dataset": ("published:" + data_dir) if data_dir
        else "synthetic stand-in (no pdc data in environment)",
        "scale": dataclasses.asdict(scale),
        "runs_truncated": truncated,
        "run_filter": run_filter,
        "seeds": seeds,
        "networks": {},
    }

    default = DenseCorrespondenceTraining.load_default_config()
    model_folders = {}
    for run in runs:
        dataset = _resolve_dataset(protocol, run.composite, data_dir, dataset_dir, scale,
                                   ds_cache)
        cfg = _training_config(default, run, scale, protocol, logging_dir)
        steps = cfg["training"]["num_iterations"]
        folder = os.path.join(logging_dir, run.name)
        final_ckpt = os.path.join(folder, "%06d.ckpt" % steps)
        if train and os.path.exists(final_ckpt):
            # resume: a run whose last checkpoint exists is done, so a rerun
            # after a failure part-way trains only what is missing
            print(f"=== [{name}] {run.name} already trained ({final_ckpt}) ===", flush=True)
        elif train:
            print(f"=== [{name}] training {run.name} ({steps} steps) ===", flush=True)
            folder = DenseCorrespondenceTraining(config=cfg, dataset=dataset,
                                                 device=device).run()
        model_folders[run.name] = folder
        summary["networks"][run.name] = {"model_folder": folder,
                                         "overrides": dict(run.overrides),
                                         "composite": run.composite or protocol.composite}

    if evaluate:
        # each network on the test split of its own train composite (the
        # reference's run_evaluation_on_network reads the network's own
        # dataset), one overlay of CDFs per composite
        groups: Dict[str, list] = {}
        for run in runs:
            groups.setdefault(run.composite or protocol.composite, []).append(run.name)
        for comp, names in groups.items():
            registry = {"networks": {n: {"model_folder": model_folders[n]} for n in names},
                        "output_dir": logging_dir,
                        "params": {"num_image_pairs": scale.num_eval_pairs,
                                   "num_matches_per_image_pair": scale.num_matches_per_pair}}
            dce = DCE(config=registry, dataset=_resolve_dataset(
                protocol, comp, data_dir, dataset_dir, scale, ds_cache), device=device)
            tag = (None if comp == protocol.composite
                   else os.path.splitext(os.path.basename(comp))[0])
            for n, stats in dce.compare_networks(network_names=names, mode="test",
                                                 tag=tag).items():
                summary["networks"][n]["test"] = {k: stats[k] for k in _STAT_KEYS if k in stats}
                summary["networks"][n]["test_composite"] = comp

        # further evaluation sets of every network (multi_object's isolated
        # and cluttered scenes)
        for save_name, comp in protocol.eval_composites:
            comp_ds = _resolve_dataset(protocol, comp, data_dir, dataset_dir, scale, ds_cache)
            comp_ds.set_test_mode()
            for n, folder in model_folders.items():
                dcn = DenseCorrespondenceNetwork.from_model_folder(folder, device=device)
                summary["networks"][n][save_name] = _quantitative_stats(
                    dcn, comp_ds, os.path.join(folder, save_name), save_name, scale)

        # the training-steps protocol scores every saved checkpoint
        if name == "caterpillar_training_steps":
            eval_ds = _resolve_dataset(protocol, None, data_dir, dataset_dir, scale, ds_cache)
            eval_ds.set_test_mode()
            for n, folder in model_folders.items():
                curve = {}
                for it in _checkpoint_iterations(folder):
                    dcn = DenseCorrespondenceNetwork.from_model_folder(folder, iteration=it,
                                                                       device=device)
                    curve[it] = _quantitative_stats(
                        dcn, eval_ds, os.path.join(folder, f"analysis_iter_{it:06d}"),
                        f"iter {it}", scale)
                summary["networks"][n]["pck_vs_steps"] = curve

    if seeds > 1 and evaluate:
        summary["seed_aggregates"] = _seed_aggregates(summary["networks"])

    out = os.path.join(logging_dir, "result.json")
    with open(out, "w") as f:
        json.dump(summary, f, indent=2, default=float)
    print(f"[{name}] result written: {out}")
    return summary
