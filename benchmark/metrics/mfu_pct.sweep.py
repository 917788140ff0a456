"""The whole edit's share of the card's peak over the profiled chunks: their
pixel-path FLOPs (``work.edit_flops``) plus both text towers' dense products
for their new prompts (``work.prompt_ops``), over the profiled span's
seconds (its first device or host event to its last), over the
configuration's peak rate.  The span starts and ends on an idle card, so
the idle at its edges counts against the card, as it would in a sweep."""

from benchmark import work


def read(run):
    t, p = run.trace, (run.window.get("profiled") or {})
    if t is None or not p.get("chunks") or not t.device_events() or run.device.type != "cuda":
        return None
    b = run.traffic["batch"]
    per_chunk = (work.edit_flops(run.cfg, run.traffic["guidance_scale"] > 1.0, b)
                 + sum(op.flops for op in work.prompt_ops(run.cfg, b)))
    return 100.0 * p["chunks"] * per_chunk / t.span_s / run.peak_flops
