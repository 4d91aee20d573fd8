"""Train step, optimizer and LR schedule (port of :mod:`pdc_tpu.training`)."""
