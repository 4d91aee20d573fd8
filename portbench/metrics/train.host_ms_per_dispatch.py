"""``train.host_ms_per_dispatch``: the host's mean time in a call of the
scanned train step (K steps) made with the device's queue drained first,
by the host's clock, over the calls that a traced run makes after its
window: the cost of enqueueing a call. The window's own calls are not
read: there the host spends most of a call waiting for room in the full
launch queue, which follows the device's step time."""


def read(record):
    host = record.get("enqueue_seconds_per_call")
    if not host:
        return None
    return 1e3 * sum(host) / len(host)
