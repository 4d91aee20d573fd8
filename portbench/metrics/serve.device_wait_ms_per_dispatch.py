"""``serve.device_wait_ms_per_dispatch``: the batcher's time blocked until a
dispatch's last kernel has ended, in ms a dispatch: the window's delta of the
server's ``stats`` ``device_wait_s`` over its ``dispatches``. Nothing to read
where the server does not count ``device_wait_s``."""


def read(record):
    stats = record.get("server_stats", {})
    if not stats.get("dispatches") or "device_wait_s" not in stats:
        return None
    return 1e3 * stats["device_wait_s"] / stats["dispatches"]
