"""``serve.host_ms_per_dispatch``: the batcher's own remaining time: assembling
the padded frames, launching the kernels, handing out the answers, in ms a
dispatch: the window's delta of the server's ``stats`` ``batcher_host_s`` over
its ``dispatches``. Nothing to read where the server does not count
``batcher_host_s``."""


def read(record):
    stats = record.get("server_stats", {})
    if not stats.get("dispatches") or "batcher_host_s" not in stats:
        return None
    return 1e3 * stats["batcher_host_s"] / stats["dispatches"]
