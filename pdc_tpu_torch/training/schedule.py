"""Learning-rate schedule.

Port of :func:`pdc_tpu.training.schedule.host_lr` (:11-18): the reference
multiplies the LR by ``learning_rate_decay`` (0.9) every
``steps_between_learning_rate_decay`` (250) iterations, a staircase.
"""


def host_lr(training_config: dict, iteration: int) -> float:
    """The staircase LR of ``iteration`` (0-based), in plain Python."""
    t = training_config["training"]
    return float(t["learning_rate"]) * float(t["learning_rate_decay"]) ** (
        iteration // int(t["steps_between_learning_rate_decay"]))
