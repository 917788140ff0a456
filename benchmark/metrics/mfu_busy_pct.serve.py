"""Served work over the card's busy time, as a share of its peak.

The profiled sub-window starts and stops between two dispatches on a
synchronised card, so it holds whole batches: their pixel-path FLOPs at
their real rows (padding rows left out, ``work.edit_flops``) plus both text
towers' dense products for their new prompts (``work.prompt_ops``), over
the device's busy time in the sub-window, over the configuration's peak."""

from benchmark import work


def read(run):
    t, p = run.trace, (run.window.get("profiled") or {})
    if t is None or not p.get("batches") or run.device.type != "cuda":
        return None
    per_row = work.edit_flops(run.cfg, run.traffic["guidance_scale"] > 1.0, 1)
    flops = sum(real * per_row + sum(op.flops for op in work.prompt_ops(run.cfg, real))
                for real, _ in p["batches"])
    busy = t.busy_s()
    return 100.0 * flops / busy / run.peak_flops if busy > 0 else None
