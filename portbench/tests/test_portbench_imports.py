"""The import guard: no module that the benchmark runs imports JAX, flax
or the JAX package ``pdc_tpu``, and the plain reference imports nothing of
the program ``pdc_tpu_torch`` either. Top-level names compare whole:
``pdc_tpu_torch`` is not ``pdc_tpu``."""

import ast
import subprocess
import sys

import pytest

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "pdc_tpu"}
SOURCES = sorted(p for p in harness.PKG.rglob("*.py") if "__pycache__" not in p.parts)


def imported_tops(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_no_forbidden_import(path):
    tops = set(imported_tops(path))
    assert not tops & FORBIDDEN
    if "reference" in path.relative_to(harness.PKG).parts:
        assert "pdc_tpu_torch" not in tops
        assert tops <= {"__future__", "math", "collections", "numpy", "torch", "portbench"}


def test_loading_every_module_loads_nothing_forbidden():
    """Every module of the benchmark imported in a fresh process (readers by
    file), then ``sys.modules`` checked by whole top-level names."""
    code = (
        "import sys, importlib\n"
        f"sys.path.insert(0, {str(harness.ROOT)!r})\n"
        "from portbench import harness\n"
        "for p in sorted(harness.PKG.rglob('*.py')):\n"
        "    rel = p.relative_to(harness.ROOT).with_suffix('')\n"
        "    if '__pycache__' in p.parts or p.name in ('conftest.py',) or p.name.startswith('test_'):\n"
        "        continue\n"
        "    if 'metrics' in rel.parts:\n"
        "        harness.load_module(p, 'm_' + p.stem.replace('.', '_'))\n"
        "    else:\n"
        "        importlib.import_module('.'.join(rel.parts).replace('.__init__', ''))\n"
        "import portbench.traffic.train, portbench.traffic.serve_closed_loop\n"
        "import pdc_tpu_torch.training.scanned, pdc_tpu_torch.apps.serve\n"
        "print(harness.forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
