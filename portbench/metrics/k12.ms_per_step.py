"""``k12.ms_per_step``: the device time of the pooled-hinge kernels, K1
(``hinge_fwd*``) and K2 (``hinge_bwd*``), in the traced window, over the
window's train steps."""


def read(record):
    trace = record.get("trace")
    if not trace or not record.get("steps"):
        return None
    us = sum(d for name, _, d, _ in trace["kernels"] if "hinge_fwd" in name or "hinge_bwd" in name)
    return us * 1e-3 / record["steps"] if us else None
