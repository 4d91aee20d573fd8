"""Import hygiene of the port: pdc_tpu_torch and chip_smoke.py import no
jax, flax or pdc_tpu module (the GPU host has none of them), optional
third-party modules are imported lazily, and importing starts no build."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "pdc_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pdc_tpu")
LAZY = ("yaml", "cv2", "PIL", "msgpack", "triton", "pandas", "matplotlib")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in sorted(names) if n.endswith(".py")]
    return files


def _modules():
    mods = []
    for path in _port_files()[1:]:
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return mods


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node, node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_ast_no_forbidden_and_only_lazy_optional_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    top_level = set(id(n) for n in tree.body)
    for node, name in _imported_names(tree):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path}: imports {name}"
        if root in LAZY:
            assert id(node) not in top_level, f"{path}: imports {name} at module top"


def test_importing_every_module_loads_no_jax_or_pdc_tpu():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + LAZY!r})\n"
        "print(','.join(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "", f"imported: {r.stdout.strip()}"


def test_import_builds_nothing_and_needs_no_nvcc():
    code = (
        "import os\n"
        "os.environ['PATH'] = ''\n"
        "os.environ.pop('CUDA_HOME', None)\n"
        "import pdc_tpu_torch.ops.best_match as bm\n"
        "import pdc_tpu_torch.ops.pooled_hinge as ph\n"
        "import pdc_tpu_torch.training.train\n"
        "from pdc_tpu_torch.ops import _build\n"
        "assert bm.launches == 0 and not _build._loaded\n"
        "assert ph.forward_launches == ph.backward_launches == 0\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


DATASET_TOOLING_AND_EXPERIMENTS = (
    "pdc_tpu_torch.data.config_gen", "pdc_tpu_torch.data.migrate",
    "pdc_tpu_torch.data.download", "pdc_tpu_torch.data.published_manifest",
    "pdc_tpu_torch.experiments", "pdc_tpu_torch.experiments.protocols",
    "pdc_tpu_torch.experiments.runner")


@pytest.mark.parametrize("module", DATASET_TOOLING_AND_EXPERIMENTS)
def test_tooling_and_experiments_import_without_yaml_jax_or_pdc_tpu(module):
    """Each imports, and the CLI lists its commands, with yaml, jax and
    pdc_tpu made unimportable: the port needs none of them."""
    assert module in _modules()
    code = (
        "import sys\n"
        "for m in ('yaml', 'jax', 'flax', 'pdc_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"import {module}\n"
        "from pdc_tpu_torch import __main__ as cli\n"
        "assert {'config-gen', 'migrate', 'download'} <= set(cli.DELEGATED)\n"
        "assert 'experiment' in cli.COMMANDS\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
