"""``serve.starved_ms_per_dispatch``: the batcher's time waiting for a batch's
first request with its queue empty, in ms a dispatch: the window's delta of
the server's ``stats`` ``starved_s`` over its ``dispatches``. Nothing to read
where the server does not count its phases.

For now the delta of a traced run also spans the profiler's start before the
window, since the traffic driver reads ``stats`` before it opens the window;
the clients send nothing then, so the batcher is starved. Until the traffic driver
reads ``stats`` after the window opens, this reader takes that stretch off:
the batcher's six phases add up to its wall time, so it is the excess of
their sum over the trace's window. The excess has to be starved time and not
negative, to within :data:`TOLERANCE_S` (the batcher adds up its phases at the
end of each dispatch and each empty poll of its queue, so either edge may
miss one); otherwise the phases are miscounted, and the reader returns None
so that the fault shows."""

PHASES = ("starved_s", "gather_s", "upload_s", "device_wait_s", "download_s", "batcher_host_s")
TOLERANCE_S = 0.25


def read(record):
    stats = record.get("server_stats", {})
    if not stats.get("dispatches") or not all(k in stats for k in PHASES):
        return None
    window = (record.get("trace") or {}).get("window_s") or record.get("window_seconds")
    starved = stats["starved_s"]
    if window:
        excess = sum(stats[k] for k in PHASES) - window
        if not -TOLERANCE_S <= excess <= starved + TOLERANCE_S:
            return None
        starved = max(0.0, starved - max(0.0, excess))
    return 1e3 * starved / stats["dispatches"]
