"""Synthetic scenes and training-sample assembly (port of :mod:`pdc_tpu.data`)."""
