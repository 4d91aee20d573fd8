"""``idle.train``: the share of the traced window in which the device ran
nothing (no kernel, copy or fill)."""


def read(record):
    trace = record.get("trace")
    if not trace or not trace["window_s"] or not trace["busy_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
