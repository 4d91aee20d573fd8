"""Headless ports of the reference's per-object experiment notebooks: a
declarative protocol registry and one shared runner (port of
:mod:`pdc_tpu.experiments`). See :mod:`pdc_tpu_torch.experiments.protocols`."""

from pdc_tpu_torch.experiments.protocols import PROTOCOLS, Protocol, Run, list_protocols
from pdc_tpu_torch.experiments.runner import Scale, run_protocol

__all__ = ["PROTOCOLS", "Protocol", "Run", "list_protocols", "Scale", "run_protocol"]
