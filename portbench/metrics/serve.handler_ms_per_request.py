"""``serve.handler_ms_per_request``: a handler thread's time on a frame request:
reading and decoding the frame, then encoding and sending the reply, in ms a
frame request: the window's delta of the server's ``stats`` ``handler_s`` over
its ``frames``. Nothing to read where the server does not count ``handler_s``."""


def read(record):
    stats = record.get("server_stats", {})
    if not stats.get("frames") or "handler_s" not in stats:
        return None
    return 1e3 * stats["handler_s"] / stats["frames"]
