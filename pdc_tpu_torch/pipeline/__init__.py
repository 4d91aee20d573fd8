"""The preprocessing pipeline: change detection (object masks and rendered
depth from a scene's fusion mesh), fused-scene access, the depth renderer
and the point-cloud segmentation toolbox. Port of :mod:`pdc_tpu.pipeline`;
``python -m pdc_tpu_torch preprocess`` runs
:func:`pdc_tpu_torch.pipeline.preprocessing.main`."""

from pdc_tpu_torch.pipeline.change_detection import (
    ChangeDetection,
    compute_foreground_mask_from_depth_image_pair,
)
from pdc_tpu_torch.pipeline.renderer import render_depth_from_points
from pdc_tpu_torch.pipeline.segmentation import (
    euclidean_cluster,
    fit_plane_ransac,
    icp_point_to_point,
    remove_radius_outliers,
    segment_table,
    voxel_down_sample,
)
