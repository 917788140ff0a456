"""The 95th percentile of every request due in the window, each timed from
when it was due to its image in hand; a failed or refused request counts as
the wait to a minute past the window's close (host clock)."""

import numpy as np


def read(run):
    lat = run.window.get("latencies_s")
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
