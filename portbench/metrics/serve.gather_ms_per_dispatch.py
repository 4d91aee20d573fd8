"""``serve.gather_ms_per_dispatch``: the batcher's time from a batch's first
request to its close (the ``max_wait_ms`` window), in ms a dispatch: the
window's delta of the server's ``stats`` ``gather_s`` over its ``dispatches``.
Nothing to read where the server does not count ``gather_s``."""


def read(record):
    stats = record.get("server_stats", {})
    if not stats.get("dispatches") or "gather_s" not in stats:
        return None
    return 1e3 * stats["gather_s"] / stats["dispatches"]
