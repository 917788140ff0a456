"""Requests per dispatched batch in the profiled sub-window: the service's
batch-size histogram (``EditService.stats()``, its real requests a batch)
read at the span's two ends, on the dispatcher's thread."""


def read(run):
    hist = (run.window.get("profiled") or {}).get("batch_hist")
    if not hist:
        return None
    n = sum(hist.values())
    return sum(int(k) * v for k, v in hist.items()) / n if n else None
