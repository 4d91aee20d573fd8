"""Learning-rate schedule.

Port of :mod:`pdc_tpu.training.schedule`: ``host_lr`` (:11-18) and
``make_lr_schedule`` (:21-28). The reference multiplies the LR by
``learning_rate_decay`` (0.9) every ``steps_between_learning_rate_decay``
(250) iterations, a staircase.
"""

import torch


def host_lr(training_config: dict, iteration: int) -> float:
    """The staircase LR of ``iteration`` (0-based), in plain Python."""
    t = training_config["training"]
    return float(t["learning_rate"]) * float(t["learning_rate_decay"]) ** (
        iteration // int(t["steps_between_learning_rate_decay"]))


def make_lr_schedule(training_config: dict):
    """The staircase as a function of a device count: ``schedule(count)``
    takes the schedule's count as a 0-dim integer tensor and returns the LR
    as a 0-dim float32 tensor on its device, with no host sync, so a
    captured Adam step can read it. It computes what optax's staircase
    ``exponential_decay`` computes, in float32: ``init * rate **
    floor(count / steps)``, and ``init`` for a count at or below 0."""
    t = training_config["training"]
    init = float(t["learning_rate"])
    rate = float(t["learning_rate_decay"])
    steps = int(t["steps_between_learning_rate_decay"])

    def schedule(count: torch.Tensor) -> torch.Tensor:
        p = torch.floor(count.to(torch.float32) / steps)
        decayed = init * torch.pow(rate, p)
        return torch.where(count <= 0, torch.full_like(decayed, init), decayed)

    return schedule
