"""Multi-process start-up: the process group, the scene split per process,
and a launcher for tests and smoke runs.

Port of :mod:`pdc_tpu.parallel.distributed` (:33-98). Where the JAX
package calls ``jax.distributed.initialize`` (from ``JAX_NUM_PROCESSES``
or the TPU metadata), the port initialises a ``torch.distributed`` process
group: NCCL when the rank's device is a CUDA card, gloo when ``"cpu"`` is
asked for. Under ``torchrun`` (``python -m torch.distributed.run
--nproc_per_node N -m pdc_tpu_torch train --data_parallel ...``) the group
comes from its ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
and ``MASTER_PORT``, and each rank is bound to ``cuda:LOCAL_RANK``. A
process started without them is a single-process run: nothing is
initialised and :func:`ensure_initialized` returns False, as the JAX one
does.

:func:`spawn` starts the ranks of a small world in this host's processes,
with a ``FileStore`` in a temporary directory (no port to contend for), for
the CPU tests (gloo) and for ``chip_smoke.py``.
"""

from __future__ import annotations

import datetime
import logging
import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from pdc_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

TIMEOUT = datetime.timedelta(seconds=600)

_initialized = False
_device: Optional[torch.device] = None


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _bind(device, local_rank: int) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def bound_device() -> torch.device:
    """This rank's device: the one :func:`ensure_initialized` bound it to,
    else ``cuda`` (``cuda:0`` of a single-process run)."""
    return _device if _device is not None else resolve_device("cuda")


def ensure_initialized(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None, device="cuda") -> bool:
    """Initialise the process group once.

    :param coordinator_address: an ``init_method`` (``tcp://host:port``,
        ``file:///path``); with ``num_processes`` and ``process_id`` it
        replaces torchrun's variables
    :param device: ``"cuda"`` (NCCL, each rank on ``cuda:LOCAL_RANK``) or
        ``"cpu"`` (gloo)
    :return: True when more than one process takes part, False for the
        single-process run (nothing initialised unless asked for
        explicitly)
    """
    global _initialized, _device
    if _initialized or dist.is_initialized():
        _initialized = True
        return dist.is_initialized() and dist.get_world_size() > 1

    explicit = coordinator_address is not None or num_processes is not None
    if not explicit and "WORLD_SIZE" not in os.environ:
        logger.info("single-process run; no process group initialised")
        _initialized = True
        return False

    if explicit:
        world = int(num_processes if num_processes is not None else 1)
        rank = int(process_id if process_id is not None else 0)
        init_method = coordinator_address
        local_rank = rank
    else:
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ.get("RANK", 0))
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        init_method = "env://"
    _device = _bind(device, local_rank)
    dist.init_process_group(_backend(_device), init_method=init_method, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    _initialized = True
    logger.info("process group initialised: rank %d/%d on %s (%s)", rank, world, _device,
                dist.get_backend())
    return world > 1


def shutdown():
    """Tear the process group down (the next :func:`ensure_initialized`
    starts again)."""
    global _initialized, _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False
    _device = None


def process_info() -> dict:
    """Topology snapshot for logs and checkpoint metadata (one device per
    process)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": world,
        "local_device_count": 1,
        "global_device_count": world,
    }


def local_scene_subset(scene_names, process_index: Optional[int] = None,
                       process_count: Optional[int] = None):
    """This process's scenes: ``sorted(names)[rank::world]``, so each
    process decodes and uploads only its own."""
    info = process_info()
    if process_index is None:
        process_index = info["process_index"]
    if process_count is None:
        process_count = info["process_count"]
    return sorted(scene_names)[process_index::process_count]


def _rank_main(rank, fn, world_size, device, tmp, threads, args):
    global _initialized, _device
    if threads:
        torch.set_num_threads(threads)
    _device = _bind(device, rank)
    store = dist.FileStore(os.path.join(tmp, "store"), world_size)
    dist.init_process_group(_backend(_device), store=store, rank=rank, world_size=world_size,
                            timeout=TIMEOUT)
    _initialized = True
    try:
        result = fn(rank, world_size, *args)
        torch.save(result, os.path.join(tmp, f"result{rank}.pt"))
    finally:
        shutdown()


def spawn(fn, world_size: int, device="cpu", *args, threads: int = 1):
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes,
    each a rank of one process group (gloo on ``"cpu"``, NCCL on
    ``"cuda"``) set up through a ``FileStore`` in a temporary directory.

    ``fn`` must be importable by name (a module-level function) and its
    arguments picklable. A rank that raises fails the call, and the others
    are stopped. Returns each rank's return value, in rank order (saved
    with ``torch.save`` and read back).

    :param threads: torch's CPU threads per rank (0 leaves the default)
    """
    import torch.multiprocessing as mp

    if device != "cpu":
        resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="pdc_spawn_") as tmp:
        mp.start_processes(_rank_main, args=(fn, world_size, device, tmp, threads, args),
                           nprocs=world_size, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"result{r}.pt"), weights_only=False)
                for r in range(world_size)]
