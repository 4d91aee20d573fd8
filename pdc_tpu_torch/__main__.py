"""Command-line interface: ``python -m pdc_tpu_torch <command> [args]``.

Only ``serve`` is ported so far:

    python -m pdc_tpu_torch serve --model_folder trained_models/net

``python -m pdc_tpu_torch serve --help`` lists its options. The other
``python -m pdc_tpu`` commands (evaluate, export-serving,
descriptor-images, ...) are still to be ported (see ROADMAP.md). ``train``
waits for the on-disk data slice, since its ``--dataset_config`` names
scenes on disk; until then train from Python with
``pdc_tpu_torch.training.train.DenseCorrespondenceTraining`` on a
synthetic dataset.
"""

from __future__ import annotations

import sys

COMMANDS = {"serve": "pdc_tpu_torch.apps.serve"}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__.strip())
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(f"unknown or not yet ported command {cmd!r}; ported: "
              f"{', '.join(sorted(COMMANDS))}", file=sys.stderr)
        return 2
    import importlib

    importlib.import_module(COMMANDS[cmd]).main(rest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
