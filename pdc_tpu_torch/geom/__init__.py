"""Pinhole camera and rigid-transform math (port of :mod:`pdc_tpu.geom`)."""
