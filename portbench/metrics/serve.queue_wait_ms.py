"""``serve.queue_wait_ms``: a frame request's time on the batcher's queue, from
its put to the batcher taking it, in ms a frame request: the window's delta of
the server's ``stats`` ``queue_wait_s`` over its ``frames``. Nothing to read
where the server does not count ``queue_wait_s``."""


def read(record):
    stats = record.get("server_stats", {})
    if not stats.get("frames") or "queue_wait_s" not in stats:
        return None
    return 1e3 * stats["queue_wait_s"] / stats["frames"]
