"""Command-line interface: ``python -m pdc_tpu_torch <command> [args]``.

Every command of ``python -m pdc_tpu``:

    python -m pdc_tpu_torch train --dataset_config <composite.yaml> --data_dir <root>
    python -m pdc_tpu_torch evaluate --model_folder trained_models/net
    python -m pdc_tpu_torch experiment caterpillar --steps 600
    python -m pdc_tpu_torch experiment --list
    python -m pdc_tpu_torch statistics --config <composite.yaml> --data_dir <root>
    python -m pdc_tpu_torch serve --model_folder trained_models/net
    python -m pdc_tpu_torch export-serving --model_folder trained_models/net --output net.pt2
    python -m pdc_tpu_torch descriptor-images --model_folder <folder> --config <composite.yaml>
    python -m pdc_tpu_torch descriptor-video --model_folder <folder> --config <composite.yaml>
    python -m pdc_tpu_torch debug-vis view|debug --config <composite.yaml>
    python -m pdc_tpu_torch preprocess --data_dir <root>/logs_proto
    python -m pdc_tpu_torch config-gen --data_dir <root> --out_dir <cfg>
    python -m pdc_tpu_torch config-gen --published --out_dir <cfg>
    python -m pdc_tpu_torch migrate --logs_dir <root>/logs_proto
    python -m pdc_tpu_torch download --config <cfg>/composite/caterpillar_only.yaml --dry_run

Each command that runs a network runs on the CUDA card unless ``--device
cpu`` is given (``--platform cpu`` for export-serving), and raises without
CUDA otherwise. ``python -m pdc_tpu_torch <command> --help`` lists a
command's options. The multi-device flags of ``train`` (``--data_parallel``,
``--fsdp``, ``--tensor_parallel``, ``--pipeline``) and ``serve``
(``--data_parallel``, ``--model_parallel``) are refused: the parallel layer
is not ported yet (see ROADMAP.md).

``experiment <protocol>`` trains every variant of one of the reference's
experiment protocols (``--list`` prints the 13), scores each network on the
test split of its composite and writes ``<logging_dir>/result.json``;
``--smoke`` is a CI-sized preset (4 steps at 64x48) that explicit sizing
flags override. Without ``--data_dir`` it uses a synthetic stand-in dataset;
with it, the composite configs under ``--dataset_dir`` (default
``configs/dataset/composite``; ``config-gen`` writes such a corpus).

``config-gen`` writes the scene-list and composite YAMLs of a data root, or
with ``--published`` those of the published pdc dataset; ``migrate`` moves
old flat scene folders into the ``processed/``/``raw/`` layout;
``download`` fetches a composite's scenes (``--dry_run`` lists them).

``preprocess`` renders every scene's object masks and depth images
(``image_masks/%06d_mask.png``, ``rendered_images/%06d_depth.png`` and
``_depth_cropped.png``) from its ``fusion_mesh.ply``, skipping scenes that
have them unless ``--redo``; ``--config_file`` takes a station crop box,
else one is fitted per scene, and ``--no_depth`` skips the full depth.

``evaluate`` writes ``descriptor_statistics.yaml`` into the model folder and
the train and test sweeps' ``data.csv`` and ``stats.yaml`` (PCK at 5-100
px, the area above the 3D-error CDF) under ``--output_dir`` (default
``<model_folder>/analysis``), plus ``across_object/`` when the dataset has
more than one object. The figures and the qualitative panels need
matplotlib: without it the figures are skipped, and the qualitative panels
must be turned off with ``--no_qualitative``.

A scene tree to train from, on the CPU (the port writes the pdc layout
itself; no download):

    python - <<'EOF'
    from pdc_tpu_torch.data.synthetic import SyntheticScene
    from pdc_tpu_torch.utils.yaml_io import save_yaml
    for i in range(2):
        SyntheticScene(seed=i, num_frames=6).write_scene(f"data/logs_proto/scene_{i}")
    save_yaml({"object_id": "disc", "train": ["scene_0", "scene_1"], "test": ["scene_1"]},
              "data/config/disc.yaml")
    save_yaml({"logs_root_path": "logs_proto",
               "single_object_scenes_config_files": ["disc.yaml"]}, "data/config/composite.yaml")
    EOF
    python -m pdc_tpu_torch train --dataset_config data/config/composite.yaml \
        --data_dir data --config <training.yaml at 64x48> --num_iterations 10 --device cpu

``train`` reads ``--config`` (default ``configs/training.yaml``) with the
port's YAML reader, builds the dataset of the composite config (the scenes
are decoded when the run first samples them) and, when the config asks for
the test loss, the test split of the same config, and writes the model
folder under ``training.logging_dir`` (default ``trained_models/``).

On the card, ``python3 chip_smoke.py`` runs ``train`` this way at 640x480
with ResNet-34-8s (its "on-disk training" phase), then ``evaluate`` on the
folder it wrote (its "evaluation" phase). PNGs are decoded by the
libpng pool where ``png.h`` is found and by the port's zlib codec
elsewhere, which gives the same arrays; the card's machine has no
``png.h`` and uses the zlib codec (:mod:`pdc_tpu_torch.data.native_loader`).
"""

from __future__ import annotations

import sys

# commands whose module's main(argv) parses its own arguments
DELEGATED = {"serve": "pdc_tpu_torch.apps.serve",
             "statistics": "pdc_tpu_torch.data.statistics",
             "export-serving": "pdc_tpu_torch.apps.export_serving",
             "descriptor-images": "pdc_tpu_torch.apps.compute_descriptor_images",
             "descriptor-video": "pdc_tpu_torch.apps.make_descriptor_video",
             "debug-vis": "pdc_tpu_torch.apps.debug_visualization",
             "preprocess": "pdc_tpu_torch.pipeline.preprocessing",
             "config-gen": "pdc_tpu_torch.data.config_gen",
             "migrate": "pdc_tpu_torch.data.migrate",
             "download": "pdc_tpu_torch.data.download"}
PARALLEL_FLAGS = ("data_parallel", "fsdp", "tensor_parallel", "pipeline")


def _cmd_train(argv):
    """Train a network with the reference's model-folder contract."""
    import argparse
    import os

    p = argparse.ArgumentParser(prog="python -m pdc_tpu_torch train")
    p.add_argument("--config", default=None,
                   help="training.yaml (default: configs/training.yaml)")
    p.add_argument("--dataset_config", required=True, help="composite dataset yaml")
    p.add_argument("--data_dir", default=".", help="pdc data root")
    p.add_argument("--name", default=None, help="model folder name (training.logging_dir_name)")
    p.add_argument("--logging_dir", default=None,
                   help="parent dir for model folders (default trained_models)")
    p.add_argument("--num_iterations", type=int, default=None,
                   help="override training.num_iterations")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    for flag in PARALLEL_FLAGS:
        p.add_argument(f"--{flag}", nargs="?", const=True, default=None,
                       help="not ported: multi-device training waits for the parallel slice")
    args = p.parse_args(argv)
    for flag in PARALLEL_FLAGS:
        if getattr(args, flag) is not None:
            p.error(f"--{flag} is not ported to pdc_tpu_torch yet: multi-device training "
                    "waits for the parallel slice")

    import torch

    from pdc_tpu_torch.data.dataset import SpartanDataset
    from pdc_tpu_torch.training.train import DenseCorrespondenceTraining
    from pdc_tpu_torch.utils.yaml_io import load_yaml

    # train in fp32, as the JAX package does: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = (load_yaml(args.config) if args.config
              else DenseCorrespondenceTraining.load_default_config())
    t = config["training"]
    if args.name:
        t["logging_dir_name"] = args.name
    if args.logging_dir:
        t["logging_dir"] = args.logging_dir
    if args.num_iterations is not None:
        t["num_iterations"] = args.num_iterations
    dataset_config = load_yaml(args.dataset_config)
    config_dir = os.path.dirname(os.path.abspath(args.dataset_config))

    def split(mode):
        return SpartanDataset(config=dataset_config, mode=mode, data_dir=args.data_dir,
                              config_dir=config_dir)

    trainer = DenseCorrespondenceTraining(
        config=config, dataset=split("train"),
        dataset_test=split("test") if t.get("compute_test_loss", False) else None,
        device=args.device)
    trainer.run()
    print(f"trained model folder: {trainer.logging_dir}")


def _cmd_evaluate(argv):
    """The analysis of a model folder (``run_evaluation_on_network``)."""
    import argparse

    p = argparse.ArgumentParser(prog="python -m pdc_tpu_torch evaluate")
    p.add_argument("--model_folder", required=True)
    p.add_argument("--num_image_pairs", type=int, default=100)
    p.add_argument("--num_matches_per_image_pair", type=int, default=100)
    p.add_argument("--output_dir", default=None, help="default: <model_folder>/analysis")
    p.add_argument("--iteration", type=int, default=None)
    p.add_argument("--no_qualitative", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if not args.no_qualitative:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            p.error("the qualitative panels need matplotlib, which is not installed: install "
                    "it, or pass --no_qualitative for the quantitative analysis alone")

    import torch

    from pdc_tpu_torch.evaluation.evaluate import DenseCorrespondenceEvaluation

    # evaluate in fp32, as the JAX package does: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = DenseCorrespondenceEvaluation.run_evaluation_on_network(
        args.model_folder, num_image_pairs=args.num_image_pairs,
        num_matches_per_image_pair=args.num_matches_per_image_pair,
        output_dir=args.output_dir, iteration=args.iteration,
        qualitative=not args.no_qualitative, device=args.device)
    print(f"analysis written: {out}")


SCALE_FLAGS = ("steps", "width", "height", "batch_size", "num_eval_pairs",
               "num_matches_per_pair", "save_rate")


def _cmd_experiment(argv):
    """Run one of the reference's experiment protocols headlessly."""
    import argparse

    p = argparse.ArgumentParser(prog="python -m pdc_tpu_torch experiment")
    p.add_argument("protocol", nargs="?", default=None, help="protocol name (omit with --list)")
    p.add_argument("--list", action="store_true", dest="list_protocols",
                   help="list available protocols")
    p.add_argument("--steps", type=int, default=None,
                   help="override per-variant training steps (default: the notebook's count)")
    p.add_argument("--width", type=int, default=None, help="default 640")
    p.add_argument("--height", type=int, default=None, help="default 480")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--num_eval_pairs", type=int, default=None, help="default 100")
    p.add_argument("--num_matches_per_pair", type=int, default=None, help="default 100")
    p.add_argument("--save_rate", type=int, default=None)
    p.add_argument("--smoke", action="store_true",
                   help="tiny CI-sized run (4 steps, 64x48); explicit sizing flags still "
                        "override its presets")
    p.add_argument("--data_dir", default=None,
                   help="pdc data root (default: synthetic stand-in dataset)")
    p.add_argument("--dataset_dir", default=None,
                   help="composite-config dir (default: configs/dataset/composite)")
    p.add_argument("--logging_dir", default=None)
    p.add_argument("--max_runs", type=int, default=None, help="truncate the variant grid")
    p.add_argument("--run_filter", default=None,
                   help="regex selecting a subset of the variant grid by run name")
    p.add_argument("--seeds", type=int, default=1,
                   help="replicate every selected run under N training seeds "
                        "(training.seed=1..N); result.json gains cross-seed aggregates")
    p.add_argument("--no_eval", action="store_true")
    p.add_argument("--eval_only", action="store_true",
                   help="skip training; evaluate the model folders already under logging_dir")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from pdc_tpu_torch.experiments import Scale, list_protocols, run_protocol

    if args.list_protocols or not args.protocol:
        for name, n_runs, desc in list_protocols():
            print(f"{name:28s} {n_runs:3d} runs  {desc}")
        return

    import torch

    # train and score in fp32, as the JAX package does: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scale = Scale.smoke() if args.smoke else Scale.full()
    for field in SCALE_FLAGS:  # --smoke is a preset: explicit flags override it
        if getattr(args, field) is not None:
            setattr(scale, field, getattr(args, field))
    run_protocol(args.protocol, scale=scale, data_dir=args.data_dir,
                 dataset_dir=args.dataset_dir, logging_dir=args.logging_dir,
                 train=not args.eval_only, evaluate=not args.no_eval, max_runs=args.max_runs,
                 run_filter=args.run_filter, seeds=args.seeds, device=args.device)


COMMANDS = {"train": _cmd_train, "evaluate": _cmd_evaluate, "experiment": _cmd_experiment}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__.strip())
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd in COMMANDS:
        COMMANDS[cmd](rest)
        return 0
    if cmd not in DELEGATED:
        print(f"unknown command {cmd!r}; commands: "
              f"{', '.join(sorted(COMMANDS) + sorted(DELEGATED))}", file=sys.stderr)
        return 2
    import importlib

    importlib.import_module(DELEGATED[cmd]).main(rest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
