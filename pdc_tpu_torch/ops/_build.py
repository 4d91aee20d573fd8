"""Build and load the port's CUDA kernels: ``nvcc`` into a plain-C shared
library, loaded with ``ctypes``.

Each ``pdc_tpu_torch/csrc/<name>.cu`` becomes
``build/pdc_tpu_torch_kernels/lib<name>-<hash>.so`` at the repository root,
where the hash covers the source and the flags, so an edited source or flag
builds anew and an unchanged one loads at once. The sources include no
PyTorch header: such a file compiles in seconds, where one that includes
``torch/extension.h`` takes minutes. :func:`build_all` starts one ``nvcc``
per source, all at once.

``nvcc`` is looked up in ``$CUDA_HOME/bin``, then on ``PATH``, then in
``/usr/local/cuda/bin``; without it the build raises. Nothing is compiled
when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "pdc_tpu_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
NVCC_TIMEOUT_S = 300

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register and spill report) of the last build per source
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, on PATH and in "
        "/usr/local/cuda/bin): the port's CUDA kernels cannot be built")


def sources() -> List[Path]:
    return sorted(SOURCE_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built, keyed by source and flags."""
    h = hashlib.sha256()
    h.update((SOURCE_DIR / f"{name}.cu").read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, nvcc: str):
    """Start nvcc on ``csrc/<name>.cu``, writing to a temporary name."""
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}-{threading.get_ident()}")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    try:
        log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc did not finish {name}.cu in {NVCC_TIMEOUT_S} s")
    build_logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all() -> Dict[str, float]:
    """Build every ``csrc/*.cu`` that is not built yet, one ``nvcc`` per
    source, all started together. Returns each source's seconds until its
    build finished (0.0 where the library already existed)."""
    names = [p.stem for p in sources()]
    seconds = dict.fromkeys(names, 0.0)
    with _lock:
        missing = [n for n in names if not library_path(n).exists()]
        if not missing:
            return seconds
        nvcc = find_nvcc()
        t0 = time.perf_counter()
        jobs = {n: _start(n, nvcc) for n in missing}
        errors = []
        for n, job in jobs.items():  # wait on every nvcc, also after a failure
            try:
                _finish(n, job)
            except RuntimeError as e:
                errors.append(str(e))
            seconds[n] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        path = library_path(name)
        if not path.exists():
            _finish(name, _start(name, find_nvcc()))
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
        return lib
