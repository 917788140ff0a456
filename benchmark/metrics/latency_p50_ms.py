"""The median of the same requests as ``latency_p95_ms``."""

import numpy as np


def read(run):
    lat = run.window.get("latencies_s")
    return float(np.percentile(lat, 50)) * 1e3 if lat else None
