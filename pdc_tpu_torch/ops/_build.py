"""Build and load the port's native libraries: ``nvcc`` (CUDA kernels) or
the host's C++ compiler (the libpng loader) into a plain-C shared library,
loaded with ``ctypes``.

Each ``pdc_tpu_torch/csrc/<name>.cu`` or ``<name>.cpp`` becomes
``build/pdc_tpu_torch_kernels/lib<name>-<hash>.so`` at the repository root,
where the hash covers the source and the flags, so an edited source or flag
builds anew and an unchanged one loads at once. A source may be built more
than once with macros (``defines``, e.g. one library per element type and
tile width), each its own library, so that a caller builds only what it
runs. A build holds an exclusive
lock on ``.<name>.lock`` in the build directory (``fcntl.flock``), so
processes that reach the first use at once (the ranks of a data-parallel
run on one host) build it once: the others wait and load the finished
file. The build writes a temporary name and renames it into place, so no
process ever loads a partial file. The sources include no PyTorch header: such a
file compiles in seconds, where one that includes ``torch/extension.h``
takes minutes. :func:`build_all` starts one ``nvcc`` per CUDA source, all at
once; ``.cpp`` sources are built by :func:`load` at first use.

``nvcc`` is looked up in ``$CUDA_HOME/bin``, then on ``PATH``, then in
``/usr/local/cuda/bin``; the C++ compiler is ``$CXX``, else ``g++`` on
``PATH``. Without the compiler a build raises. Nothing is compiled when this
module is imported.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
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
# host C++ sources (csrc/*.cpp): flags before the source, libraries after it
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
CXX_LIBS = ("-lpng", "-lz", "-lpthread")
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


def find_cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler ($CXX unset and no g++ on PATH): the port's "
                           "host libraries cannot be built")
    return cxx


def sources() -> List[Path]:
    """The CUDA sources (``csrc/*.cu``); :func:`build_all` builds these."""
    return sorted(SOURCE_DIR.glob("*.cu"))


def _source(name: str) -> Path:
    cu = SOURCE_DIR / f"{name}.cu"
    return cu if cu.exists() else SOURCE_DIR / f"{name}.cpp"


def _flags(source: Path):
    return NVCC_FLAGS if source.suffix == ".cu" else CXX_FLAGS + CXX_LIBS


def _macros(defines) -> tuple:
    return tuple(f"-D{d}" for d in defines)


def _label(name: str, defines=()) -> str:
    """``name``, or ``name[A=1,B=2]`` for a build with macros."""
    return f"{name}[{','.join(defines)}]" if defines else name


def library_path(name: str, defines=()) -> Path:
    """Where ``csrc/<name>.cu`` (or ``.cpp``) is built with the macros
    ``defines`` (``"NAME=value"`` strings), keyed by source, flags and
    macros."""
    source = _source(name)
    h = hashlib.sha256()
    h.update(source.read_bytes())
    h.update("\0".join(_flags(source) + _macros(defines)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, defines=()):
    """Start the compiler on ``csrc/<name>``, writing to a temporary name."""
    source = _source(name)
    out = library_path(name, defines)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}-{threading.get_ident()}")
    if source.suffix == ".cu":
        cmd = [find_nvcc(), *NVCC_FLAGS, *_macros(defines), "-o", str(tmp), str(source)]
    else:
        cmd = [find_cxx(), *CXX_FLAGS, *_macros(defines), "-o", str(tmp), str(source),
               *CXX_LIBS]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out, source.name, os.path.basename(cmd[0])


def _finish(name: str, job) -> None:
    """Wait for a build; ``name`` is its :func:`_label`."""
    proc, tmp, out, source, compiler = job
    try:
        log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{compiler} did not finish {source} in {NVCC_TIMEOUT_S} s")
    build_logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{compiler} failed on {source} (exit {proc.returncode}):\n{log}")
    log_tmp = tmp.with_name(tmp.name + ".log")
    log_tmp.write_text(log)
    os.replace(log_tmp, _log_path(out))
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


@contextlib.contextmanager
def _build_lock(name: str):
    """An exclusive lock, across processes, on building ``csrc/<name>``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".{name}.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _log_path(lib: Path) -> Path:
    return lib.with_name(f"{lib.name}.log")


def build_log(name: str, defines=()) -> str:
    """The compiler's output for the built ``csrc/<name>`` (kept beside the
    library), or "" if it was never built here."""
    label = _label(name, defines)
    if label in build_logs:
        return build_logs[label]
    path = _log_path(library_path(name, defines))
    return path.read_text() if path.exists() else ""


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """Registers and spill bytes per kernel from nvcc's ``-Xptxas=-v``
    output: ``{mangled name: {"registers", "spill_stores", "spill_loads"}}``."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {"registers": 0, "spill_stores": 0, "spill_loads": 0})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_stores"], out[name]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def build_all() -> Dict[str, float]:
    """Build every ``csrc/*.cu`` that is not built yet, one ``nvcc`` per
    source, all started together. Returns each source's seconds until its
    build finished (0.0 where the library already existed)."""
    names = [p.stem for p in sources()]
    seconds = dict.fromkeys(names, 0.0)
    with _lock, contextlib.ExitStack() as locks:
        missing = [n for n in names if not library_path(n).exists()]
        if not missing:
            return seconds
        for n in missing:  # in sorted order, so processes never deadlock
            locks.enter_context(_build_lock(n))
        missing = [n for n in missing if not library_path(n).exists()]  # built meanwhile
        t0 = time.perf_counter()
        jobs = {n: _start(n) for n in missing}
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


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``.cpp``) with the
    macros ``defines``, built first if needed."""
    defines = tuple(defines)
    label = _label(name, defines)
    with _lock:
        lib = _loaded.get(label)
        if lib is not None:
            return lib
        path = library_path(name, defines)
        if not path.exists():
            with _build_lock(name):
                if not path.exists():  # another process may have built it meanwhile
                    _finish(label, _start(name, defines))
        lib = ctypes.CDLL(str(path))
        _loaded[label] = lib
        return lib
