"""Spatial convolutions against their roofline: the least time of the
profiled chunks' convolutions (``work.edit_ops``, family ``conv``: each
op's needed operations at the configuration's peak or its least bytes at
the memory bandwidth, whichever is longer) over the device time of every
kernel in the ``conv`` family (``families.json``)."""

from benchmark import work


def read(run):
    t, p = run.trace, (run.window.get("profiled") or {})
    if t is None or not p.get("chunks"):
        return None
    device_s = t.family_s(run.families).get("conv", 0.0)
    if device_s <= 0:
        return None
    ops = [op for op in work.edit_ops(run.cfg, run.traffic["guidance_scale"] > 1.0,
                                      run.traffic["batch"]) if op.family == "conv"]
    least = p["chunks"] * work.least_seconds(ops, run.peak_flops, run.peaks["hbm_bytes_per_s"])
    return 100.0 * least / device_s
