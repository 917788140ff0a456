"""Host ms per ``edit_batch_async`` call, mean over the window's calls
outside the profiled sub-window (the benchmark's span around the call)."""


def read(run):
    d = run.window.get("dispatch_s")
    return 1e3 * sum(d) / len(d) if d else None
