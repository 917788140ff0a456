"""Host ms of the facade's prompt encoding per new prompt: the window's
``facade.encode_prompts`` records outside the profiled sub-window
(tokenizing, the prompt graph's look-up, copies and replay, the cached
rows' copies; ``fastedit_tpu_torch.utils.profiling``), their seconds over
their new prompts."""


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
    rs = [r for r in records("facade.encode_prompts", t0, t1)
          if p0 is None or r.t1_ns < p0 or r.t0_ns > p1]
    prompts = sum(r.ids["new_prompts"] for r in rs)
    return sum(r.t1_ns - r.t0_ns for r in rs) / prompts / 1e6 if prompts else None
