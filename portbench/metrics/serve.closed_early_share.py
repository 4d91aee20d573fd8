"""``serve.closed_early_share``: the share of the window's dispatches whose
gather the batcher closed before the batch was full and before
``max_wait_ms``, every open connection's frame already in it, in %: the
window's delta of the server's ``stats`` ``closed_early`` over its
``dispatches``. Nothing to read where the server does not count
``closed_early``."""


def read(record):
    stats = record.get("server_stats", {})
    if not stats.get("dispatches") or "closed_early" not in stats:
        return None
    return 100.0 * stats["closed_early"] / stats["dispatches"]
