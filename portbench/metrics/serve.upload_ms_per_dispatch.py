"""``serve.upload_ms_per_dispatch``: the batcher's time copying a batch's frames
and queries to the card, in ms a dispatch: the window's delta of the server's
``stats`` ``upload_s`` over its ``dispatches``. Nothing to read where the
server does not count ``upload_s``."""


def read(record):
    stats = record.get("server_stats", {})
    if not stats.get("dispatches") or "upload_s" not in stats:
        return None
    return 1e3 * stats["upload_s"] / stats["dispatches"]
