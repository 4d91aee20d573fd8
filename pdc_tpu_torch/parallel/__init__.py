"""The data axis of the multi-device layer on ``torch.distributed``: the
mesh, process start-up, data-parallel and ZeRO (FSDP) training, sharded
inference and the pixel-sharded best match. The names of
:mod:`pdc_tpu.parallel` that this layer ports; tensor parallelism and the
pipeline are ROADMAP queue 1 item 9b."""

from pdc_tpu_torch.parallel.distributed import (
    ensure_initialized,
    local_scene_subset,
    process_info,
    spawn,
)
from pdc_tpu_torch.parallel.mesh import Mesh, make_mesh
from pdc_tpu_torch.parallel.sharded_train import (
    make_pixel_sharded_best_match,
    make_sharded_inference,
    make_sharded_train_step,
    shard_host_batch,
)
from pdc_tpu_torch.parallel.tensor_parallel import fsdp_shardings, make_fsdp_train_step

__all__ = ["Mesh", "ensure_initialized", "fsdp_shardings", "local_scene_subset",
           "make_fsdp_train_step", "make_mesh", "make_pixel_sharded_best_match",
           "make_sharded_inference", "make_sharded_train_step", "process_info",
           "shard_host_batch", "spawn"]
