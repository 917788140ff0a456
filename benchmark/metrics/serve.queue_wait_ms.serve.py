"""Mean ms a request waits in the service's queue, from ``submit`` to the
dispatcher taking it into a batch (``serve.queue_wait``;
``fastedit_tpu_torch.utils.profiling``), over the requests due in the
window: the first ``attempted`` submitted after it opened."""


def read(run):
    if run.device.type != "cuda" or not run.window.get("window_s"):
        return None
    try:
        from fastedit_tpu_torch.utils.profiling import records
    except ImportError:  # a program without the records
        return None
    t0 = round((run.t_start + run.setup_s) * 1e9)
    waits = sorted((r for r in records("serve.queue_wait") if r.t0_ns >= t0),
                   key=lambda r: r.t0_ns)[:run.window["attempted"]]
    return sum(r.t1_ns - r.t0_ns for r in waits) / len(waits) / 1e6 if waits else None
