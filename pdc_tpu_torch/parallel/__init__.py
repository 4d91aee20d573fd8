"""The multi-device layer on ``torch.distributed``: the mesh, process
start-up, data-parallel and ZeRO (FSDP) training, sharded inference, the
pixel-sharded best match, and the model axes: tensor (channel) parallelism
and the GPipe pipeline. The names of :mod:`pdc_tpu.parallel` that this
layer ports."""

from pdc_tpu_torch.parallel.distributed import (
    ensure_initialized,
    local_scene_subset,
    process_info,
    spawn,
)
from pdc_tpu_torch.parallel.mesh import Mesh, make_mesh
from pdc_tpu_torch.parallel.pipeline import (
    PPTrainState,
    make_frozen_bn_train_step,
    make_pp_inference,
    make_pp_train_step,
    pack_pipeline_variables,
    unpack_pipeline_variables,
)
from pdc_tpu_torch.parallel.sharded_train import (
    make_pixel_sharded_best_match,
    make_sharded_inference,
    make_sharded_train_step,
    shard_host_batch,
)
from pdc_tpu_torch.parallel.tensor_parallel import (
    channel_shardings,
    fsdp_shardings,
    make_fsdp_train_step,
    make_tp_inference,
    make_tp_train_step,
)

__all__ = ["Mesh", "PPTrainState", "channel_shardings", "ensure_initialized", "fsdp_shardings",
           "local_scene_subset", "make_frozen_bn_train_step", "make_fsdp_train_step",
           "make_mesh", "make_pixel_sharded_best_match", "make_pp_inference",
           "make_pp_train_step", "make_sharded_inference", "make_sharded_train_step",
           "make_tp_inference", "make_tp_train_step", "pack_pipeline_variables",
           "process_info", "shard_host_batch", "spawn", "unpack_pipeline_variables"]
