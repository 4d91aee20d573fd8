"""``serve.download_ms_per_dispatch``: the batcher's time copying a dispatch's
answers to the host, in ms a dispatch: the window's delta of the server's
``stats`` ``download_s`` over its ``dispatches``. Nothing to read where the
server does not count ``download_s``."""


def read(record):
    stats = record.get("server_stats", {})
    if not stats.get("dispatches") or "download_s" not in stats:
        return None
    return 1e3 * stats["download_s"] / stats["dispatches"]
