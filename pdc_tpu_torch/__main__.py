"""Command-line interface: ``python -m pdc_tpu_torch <command> [args]``.

Ported commands:

    python -m pdc_tpu_torch train --dataset_config <composite.yaml> --data_dir <root>
    python -m pdc_tpu_torch evaluate --model_folder trained_models/net
    python -m pdc_tpu_torch statistics --config <composite.yaml> --data_dir <root>
    python -m pdc_tpu_torch serve --model_folder trained_models/net
    python -m pdc_tpu_torch export-serving --model_folder trained_models/net --output net.pt2
    python -m pdc_tpu_torch descriptor-images --model_folder <folder> --config <composite.yaml>
    python -m pdc_tpu_torch descriptor-video --model_folder <folder> --config <composite.yaml>
    python -m pdc_tpu_torch debug-vis view|debug --config <composite.yaml>

Each runs on the CUDA card unless ``--device cpu`` is given (``--platform
cpu`` for export-serving), and raises without CUDA otherwise. ``python -m
pdc_tpu_torch <command> --help`` lists a command's options. The other
``python -m pdc_tpu`` commands (preprocess, config-gen, experiment, ...) are
still to be ported (see ROADMAP.md).

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
             "debug-vis": "pdc_tpu_torch.apps.debug_visualization"}
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


COMMANDS = {"train": _cmd_train, "evaluate": _cmd_evaluate}


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
        print(f"unknown or not yet ported command {cmd!r}; ported: "
              f"{', '.join(sorted(DELEGATED) + sorted(COMMANDS))}", file=sys.stderr)
        return 2
    import importlib

    importlib.import_module(DELEGATED[cmd]).main(rest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
