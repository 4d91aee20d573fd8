"""Evaluation of a trained network: the quantitative sweeps and their
23-column match statistics, the CDF plotter and its stats, descriptor
statistics, qualitative panels and cross-instance keypoints.

Port of :mod:`pdc_tpu.evaluation`. Tables are
:class:`pdc_tpu_torch.evaluation.table.Table`, not pandas DataFrames, and
pandas, matplotlib and cv2 are imported only by the functions that draw or
convert (:mod:`pdc_tpu_torch.evaluation.evaluate` explains the rest).
"""

from pdc_tpu_torch.evaluation.evaluate import DenseCorrespondenceEvaluation
from pdc_tpu_torch.evaluation.keypoints import (
    evaluate_network_cross_scene_keypoints,
    keypoint_statistics,
    run_cross_instance_keypoint_evaluation_on_network,
)
from pdc_tpu_torch.evaluation.plotting import (
    DenseCorrespondenceEvaluationPlotter,
    normalize_descriptor,
    normalize_descriptor_pair,
)
from pdc_tpu_torch.evaluation.qualitative import (
    evaluate_network_qualitative,
    make_2d_cluster_plot,
    plot_descriptor_colormaps,
    single_image_pair_qualitative_analysis,
)
from pdc_tpu_torch.evaluation.table import Table, read_csv
