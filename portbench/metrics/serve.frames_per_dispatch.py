"""``serve.frames_per_dispatch``: the frames a dispatch of the server's
batcher carried in the window, from the deltas of its ``stats`` counters
(``frames`` over ``dispatches``)."""


def read(record):
    stats = record.get("server_stats", {})
    if not stats.get("dispatches"):
        return None
    return stats["frames"] / stats["dispatches"]
