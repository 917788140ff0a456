"""Dense products against their roofline: the least time of the profiled
chunks' linear layers and 1x1 convs (``work.edit_ops``, family ``linear``)
and of both text towers' dense products for the chunks' new prompts
(``work.prompt_ops``), over the device time of every GEMM kernel (family
``linear``)."""

from benchmark import work


def read(run):
    t, p = run.trace, (run.window.get("profiled") or {})
    if t is None or not p.get("chunks"):
        return None
    device_s = t.family_s(run.families).get("linear", 0.0)
    if device_s <= 0:
        return None
    b = run.traffic["batch"]
    ops = [op for op in work.edit_ops(run.cfg, run.traffic["guidance_scale"] > 1.0, b)
           if op.family == "linear"] + work.prompt_ops(run.cfg, b)
    least = p["chunks"] * work.least_seconds(ops, run.peak_flops, run.peaks["hbm_bytes_per_s"])
    return 100.0 * least / device_s
