"""Train step, optimizer, LR schedule, the on-device pair sampler and the
training driver (port of :mod:`pdc_tpu.training`)."""
