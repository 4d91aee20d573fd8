"""Declarative registry of the reference's per-object experiment protocols.

The port's own copy of :mod:`pdc_tpu.experiments.protocols` (:30-335): the
same 13 protocols, with the same names, runs, overrides, composites,
evaluation composites and synthetic stand-in sizes
(tests/test_torch_port_experiments.py holds them field for field). Each
protocol is one of the reference's experiment notebooks
(``dense_correspondence/experiments/``) as data: a composite dataset config,
a grid of variants, each variant's changes to the training config (dotted
keys), and the datasets every network is scored on. One runner,
:mod:`pdc_tpu_torch.experiments.runner`, executes any of them:

    python -m pdc_tpu_torch experiment normalize_descriptors --steps 600
    python -m pdc_tpu_torch experiment multi_object --data_dir /path/to/pdc

Without ``--data_dir`` the runner trains and scores on a synthetic stand-in
dataset of the same structure, and the summary says so.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Run:
    """One trained network inside a protocol.

    :param name: model-folder name (mirrors the reference's ``name =`` lines)
    :param overrides: dotted-key -> value mutations of the training config
    :param composite: train composite yaml; None -> the protocol default
    """

    name: str
    overrides: Dict[str, object] = dataclasses.field(default_factory=dict)
    composite: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Protocol:
    """One reference experiment directory, as a runnable recipe."""

    name: str
    reference_dir: str          # under dense_correspondence/experiments/
    description: str
    composite: str              # default train composite yaml name
    num_iterations: int         # the notebook's full-scale step count
    runs: Tuple[Run, ...]
    # extra evaluation datasets: (save_folder_name, composite yaml name);
    # every network is additionally scored on each (multi_object's
    # analysis_isolated_scene / analysis_cluttered_scene split)
    eval_composites: Tuple[Tuple[str, str], ...] = ()
    # synthetic stand-in factory kwargs (SpartanDataset.make_synthetic)
    synthetic: Dict[str, object] = dataclasses.field(default_factory=dict)


# -- helpers -------------------------------------------------------------------

def _m_grid(prefix: str, m_list, d_list, extra=None, composite=None):
    """The reference notebooks' nested ``for M_background: for d:`` loop."""
    runs = []
    for m in m_list:
        for d in d_list:
            ov = {"loss_function.M_background": float(m),
                  "dense_correspondence_network.descriptor_dimension": int(d)}
            if extra:
                ov.update(extra)
            runs.append(Run(name=f"{prefix}_M_background_{m:.3f}_{d}",
                            overrides=ov, composite=composite))
    return tuple(runs)


_SINGLE = dict(num_scenes=3, num_objects=1, num_test_scenes=1, num_frames=10,
               object_radius=0.3)
_MULTI = dict(num_scenes=4, num_objects=2, num_test_scenes=2, num_frames=10,
              object_radius=0.3)
_CLASS = dict(num_scenes=4, num_objects=4, num_test_scenes=2, num_frames=10,
              object_radius=0.3)


# -- the registry --------------------------------------------------------------

PROTOCOLS: Dict[str, Protocol] = {}


def _register(p: Protocol):
    PROTOCOLS[p.name] = p
    return p


_register(Protocol(
    name="caterpillar",
    reference_dir="caterpillar",
    description="Standard single-object training on caterpillar_only at "
                "d=3 under two background margins "
                "(training_caterpillar.ipynb).",
    composite="caterpillar_only.yaml",
    num_iterations=3500,
    runs=_m_grid("caterpillar", [0.5, 2.0], [3]),
    synthetic=_SINGLE,
))

_register(Protocol(
    name="caterpillar_backbone",
    reference_dir="caterpillar",
    description="Backbone capacity ablation: the caterpillar protocol with "
                "a ResNet-101 (vs default ResNet-34) feature extractor and "
                "the long 15k-step decay schedule "
                "(training_caterpillar_backbone.ipynb).",
    composite="caterpillar_only.yaml",
    num_iterations=15000,
    runs=(
        Run("caterpillar_Resnet34", {
            "loss_function.M_background": 0.5,
            "dense_correspondence_network.descriptor_dimension": 3,
            "training.learning_rate_decay": 0.5,
            "training.steps_between_learning_rate_decay": 3000}),
        Run("caterpillar_Resnet101", {
            "loss_function.M_background": 0.5,
            "dense_correspondence_network.descriptor_dimension": 3,
            "training.learning_rate_decay": 0.5,
            "training.steps_between_learning_rate_decay": 3000,
            "dense_correspondence_network.backbone.resnet_name":
                "Resnet101_8s"}),
    ),
    synthetic=_SINGLE,
))

_register(Protocol(
    name="caterpillar_training_steps",
    reference_dir="caterpillar",
    description="Training-length study: 15k steps with 0.5x LR decay every "
                "3k, evaluated at every 1k-step checkpoint "
                "(training_caterpillar_training_steps.ipynb; the runner "
                "evaluates each saved iteration).",
    composite="caterpillar_only.yaml",
    num_iterations=15000,
    runs=(
        Run("caterpillar_steps", {
            "loss_function.M_background": 0.5,
            "dense_correspondence_network.descriptor_dimension": 3,
            "training.learning_rate_decay": 0.5,
            "training.steps_between_learning_rate_decay": 3000,
            # the study IS the per-checkpoint curve — keep every 1k-step
            # checkpoint (the notebook evaluates each saved iteration)
            "training.save_rate": 1000}),
    ),
    synthetic=_SINGLE,
))

_register(Protocol(
    name="shoes",
    reference_dir="shoes",
    description="Class-specific vs class-consistent shoe descriptors on 4 "
                "shoes (training_shoes.ipynb): the consistent variant "
                "trains within-scene only; the specific variant mixes "
                "DIFFERENT_OBJECT and SYNTHETIC_MULTI_OBJECT repulsion.",
    composite="shoe_train_4_shoes.yaml",
    num_iterations=3500,
    runs=(
        _m_grid("shoes_consistent", [0.5], [6, 9])
        + _m_grid("shoes_specific", [0.5], [6, 9], extra={
            "training.data_type_probabilities.SINGLE_OBJECT_WITHIN_SCENE": 0.33,
            "training.data_type_probabilities.DIFFERENT_OBJECT": 0.33,
            "training.data_type_probabilities.SYNTHETIC_MULTI_OBJECT": 0.33})
    ),
    synthetic=_CLASS,
))

_register(Protocol(
    name="shoes_consistent",
    reference_dir="shoes_consistent",
    description="The shoes protocol over the full shoe set "
                "(shoe_train_all_shoes.yaml; shoes_consistent/"
                "training_shoes.ipynb).",
    composite="shoe_train_all_shoes.yaml",
    num_iterations=3500,
    runs=(
        _m_grid("shoes_consistent", [0.5], [6])
        + _m_grid("shoes_specific", [0.5], [6], extra={
            "training.data_type_probabilities.SINGLE_OBJECT_WITHIN_SCENE": 0.33,
            "training.data_type_probabilities.DIFFERENT_OBJECT": 0.33,
            "training.data_type_probabilities.SYNTHETIC_MULTI_OBJECT": 0.33})
    ),
    synthetic=_CLASS,
))

_register(Protocol(
    name="hats",
    reference_dir="hats",
    description="Class-specific vs class-consistent hat descriptors on 6 "
                "hats over an M_background x D grid (training_hats.ipynb); "
                "the specific variant adds 25% DIFFERENT_OBJECT repulsion.",
    composite="hat_train_6.yaml",
    num_iterations=3500,
    runs=(
        _m_grid("hats_consistent", [0.5, 2.0], [3, 6, 9])
        + _m_grid("hats_specific", [0.5, 2.0], [3, 6, 9], extra={
            "training.data_type_probabilities.SINGLE_OBJECT_WITHIN_SCENE": 0.75,
            "training.data_type_probabilities.DIFFERENT_OBJECT": 0.25})
    ),
    synthetic=_CLASS,
))

_register(Protocol(
    name="mugs",
    reference_dir="mugs",
    description="Class-consistent mug descriptors over three background "
                "margins (training_mugs.ipynb + mugs_qualitative_plots).",
    composite="mugs_all.yaml",
    num_iterations=3500,
    runs=_m_grid("mugs_consistent", [1.0, 2.0, 0.5], [3]),
    synthetic=_CLASS,
))

_register(Protocol(
    name="baymax",
    reference_dir="baymax",
    description="Single-object baymax descriptors at two background "
                "margins (training_baymax.ipynb).",
    composite="baymax_front_only.yaml",
    num_iterations=3500,
    runs=_m_grid("baymax", [1.0, 0.5], [3]),
    synthetic=_SINGLE,
))

_register(Protocol(
    name="starbot",
    reference_dir="starbot",
    description="Single-object starbot descriptors at two background "
                "margins (training_starbot.ipynb).",
    composite="star_bot_front_only.yaml",
    num_iterations=3500,
    runs=_m_grid("starbot", [1.0, 0.5], [3]),
    synthetic=_SINGLE,
))

# NOTE: the reference's multi_object notebook writes the margin to
# training.M_background — a key nothing reads (the loss reads
# loss_function.M_background, evaluation.py / loss_composer). We apply the
# margin to the live key, which is what the notebook intended.
_register(Protocol(
    name="multi_object",
    reference_dir="multi_object",
    description="Descriptor-dimension x background-margin grid for "
                "isolated-scene vs cluttered-scene training "
                "(training_multi_object.ipynb); every network is scored on "
                "both an isolated and a cluttered evaluation set.",
    composite="caterpillar_baymax_starbot_all_front_single_only.yaml",
    num_iterations=5000,
    runs=(
        _m_grid("multi_object_isolated", [0.5, 1.0, 1.5, 2.0], [9, 16, 32],
                extra={
            "training.data_type_probabilities.SINGLE_OBJECT_WITHIN_SCENE": 0.5,
            "training.data_type_probabilities.DIFFERENT_OBJECT": 0.5})
        + _m_grid("multi_object_cluttered", [0.5, 1.0, 1.5, 2.0], [9, 16, 32],
                  composite="caterpillar_baymax_starbot_all_front.yaml",
                  extra={
            "training.data_type_probabilities.SINGLE_OBJECT_WITHIN_SCENE": 0.5,
            "training.data_type_probabilities.DIFFERENT_OBJECT": 0.25,
            "training.data_type_probabilities.MULTI_OBJECT": 0.25})
    ),
    eval_composites=(
        ("analysis_isolated_scene",
         "caterpillar_baymax_starbot_all_front_single_only.yaml"),
        ("analysis_cluttered_scene",
         "caterpillar_baymax_starbot_all_front.yaml"),
    ),
    synthetic=_MULTI,
))

_register(Protocol(
    name="domain_randomization",
    reference_dir="domain_randomization",
    description="Domain-randomization A/B on baymax: identical training "
                "with background randomization on vs off "
                "(training_domain_randomization.ipynb; knob at "
                "pdc_tpu/ops/augmentation.py).",
    composite="baymax_front_only.yaml",
    num_iterations=3500,
    runs=(
        Run("baymax_standard_3", {
            "dense_correspondence_network.descriptor_dimension": 3}),
        Run("baymax_no_domain_randomization_3", {
            "dense_correspondence_network.descriptor_dimension": 3,
            "training.domain_randomize": False}),
    ),
    synthetic=_SINGLE,
))

_register(Protocol(
    name="normalize_descriptors",
    reference_dir="normalize_descriptors",
    description="L2-normalized descriptor head ablation on the "
                "three-object set (training_normalize_descriptors.ipynb; "
                "knob at pdc_tpu/models/dcn.py normalize).",
    composite="caterpillar_baymax_starbot_all_front_single_only.yaml",
    num_iterations=3500,
    runs=(
        Run("standard_4", {
            "dense_correspondence_network.descriptor_dimension": 4}),
        Run("normalize_descriptors_4", {
            "dense_correspondence_network.descriptor_dimension": 4,
            "dense_correspondence_network.normalize": True}),
    ),
    synthetic=_MULTI,
))

_register(Protocol(
    name="benchmark",
    reference_dir="benchmark",
    description="The two-task benchmark (training_benchmark.ipynb): the "
                "three-object cbs task and the class-consistent shoes "
                "task, trained with stock settings.",
    composite="caterpillar_baymax_starbot_all_front_single_only.yaml",
    num_iterations=3500,
    runs=(
        Run("cbs_3", {
            "dense_correspondence_network.descriptor_dimension": 3}),
        Run("shoes_consistent_3", {
            "dense_correspondence_network.descriptor_dimension": 3},
            composite="shoe_train_all_shoes.yaml"),
    ),
    synthetic=_MULTI,
))


def list_protocols():
    """(name, #runs, description) rows for the CLI."""
    return [(p.name, len(p.runs), p.description)
            for p in PROTOCOLS.values()]
