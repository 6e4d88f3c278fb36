"""``idle_share.prefill``: the share of the traced window in which no device
operation ran: 1 - (union of the device intervals) / (the window's wall time), in %."""


def read(run):
    t = run.trace_summary
    if t is None or "requests" not in run.records or not t.window_ns:
        return None
    return 100.0 * (1.0 - t.busy_ns / t.window_ns)
