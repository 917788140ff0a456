"""Kernel nodes of the denoise graph of the cell's key per run step: the
``graphs.kernels`` record of its capture (stage ``denoise``, the traffic's
batch and guidance; the nodes counted in the captured graph,
``fastedit_tpu_torch.pipeline.graphs``) over the steps it runs, the last
capture's.  The launches one replay of a step makes."""


def read(run):
    if run.device.type != "cuda":
        return None
    try:
        from fastedit_tpu_torch.utils.profiling import records
    except ImportError:  # a program without the records
        return None
    cfg = run.traffic["guidance_scale"] > 1.0
    rs = [r for r in records("graphs.kernels")
          if r.ids.get("stage") == "denoise" and r.ids.get("batch") == run.traffic["batch"]
          and r.ids.get("cfg") == cfg]
    return rs[-1].ids["kernels"] / rs[-1].ids["steps"] if rs else None
