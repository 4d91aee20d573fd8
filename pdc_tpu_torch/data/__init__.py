"""Synthetic scenes, the dataset and its device cache, and training-sample
assembly (port of :mod:`pdc_tpu.data`)."""
