"""Seconds of set-up in the editor's constructor: the ``facade.build``
record (the modules built and filled with zeros, the runtime's caches;
``fastedit_tpu_torch.utils.profiling``) between the process's start and
the window's opening."""


def read(run):
    if run.device.type != "cuda" or run.setup_s is None:
        return None
    try:
        from fastedit_tpu_torch.utils.profiling import records
    except ImportError:  # a program without the records
        return None
    s0 = round(run.t_start * 1e9)
    rs = records("facade.build", s0, s0 + round(run.setup_s * 1e9))
    return sum(r.t1_ns - r.t0_ns for r in rs) / 1e9 if rs else None
