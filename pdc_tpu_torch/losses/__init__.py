"""Contrastive losses (port of :mod:`pdc_tpu.losses`)."""
