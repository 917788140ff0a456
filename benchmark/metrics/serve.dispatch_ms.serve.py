"""Mean host ms of the dispatcher's call of the editor per batch
(``serve.dispatch``, around ``edit_batch_async``;
``fastedit_tpu_torch.utils.profiling``), over the batches of the requests
due in the window: the first ``attempted`` submitted after it opened."""


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
    batches = {r.ids["batch"] for r in waits}
    ns = [r.t1_ns - r.t0_ns for r in records("serve.dispatch") if r.ids["batch"] in batches]
    return sum(ns) / len(ns) / 1e6 if ns else None
