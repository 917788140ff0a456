"""Device ms of the ControlNet per edit: each chunk's
``stage.denoise.controlnet`` record (the card's clock stamped at each denoise
step's ControlNet start and UNet start inside the denoise graph, copied out
behind its replay and summed over the steps;
``fastedit_tpu_torch.utils.profiling``) over its rows, mean over the
window's chunks outside the profiled sub-window."""


def read(run):
    if run.device.type != "cuda" or not run.window.get("window_s"):
        return None
    try:
        from fastedit_tpu_torch.utils.profiling import profiler_offset_ns, records
    except ImportError:  # a program without the records
        return None
    t0 = round((run.t_start + run.setup_s) * 1e9)
    t1 = t0 + round(run.window["window_s"] * 1e9)
    p0 = p1 = None
    if run.trace is not None and run.trace.events:
        p0, p1 = run.trace.t0_ns - profiler_offset_ns(), run.trace.t1_ns - profiler_offset_ns()
    ms = [r.ids["device_ns"] / r.ids["rows"] / 1e6
          for r in records("stage.denoise.controlnet", t0, t1)
          if p0 is None or r.t1_ns < p0 or r.t0_ns > p1]
    return sum(ms) / len(ms) if ms else None
