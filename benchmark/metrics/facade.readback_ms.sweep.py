"""Host ms per chunk of the readback's own host work: ``facade.to_pil``
(the pinned buffer to PIL images; the wait for the copy left out) summed
over each chunk's records (by its ``edit`` id), mean over the chunks whose
records all lie in the window and outside the profiled sub-window
(``fastedit_tpu_torch.utils.profiling``)."""


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
    chunks = {}
    for r in records("facade.to_pil"):
        chunks.setdefault(r.ids["edit"], []).append(r)
    ns = [sum(r.t1_ns - r.t0_ns for r in rs) for rs in chunks.values()
          if all(t0 <= r.t0_ns and r.t1_ns <= t1 and (p0 is None or r.t1_ns < p0 or r.t0_ns > p1)
                 for r in rs)]
    return sum(ns) / len(ns) / 1e6 if ns else None
