"""The share of the profiled sub-window in which no device operation ran."""


def read(run):
    t = run.trace
    if t is None or not t.device_events():
        return None
    return 100.0 * (1.0 - t.busy_s() / t.span_s)
