"""Benchmark: seconds per 1024² 4-step LCM ControlNet edit on one NVIDIA card.

    python -m fastedit_tpu_torch.bench [--reps N]

The port of the JAX package's ``bench.py``: the same phases and key names,
measured on the card.  It prints progress to stderr and, last on stdout, one
JSON line:

    {"metric": "seconds_per_1024px_4step_edit", "value": N, "unit": "s",
     "vs_baseline": N, ...}

``vs_baseline`` is 6.0 s (the reference's headline: SSD-1B fp16 with CPU
offload on an RTX 3060 Laptop, ``BASELINE.md``) over ``value``.  The edit is
``FastEditor("ssd-1b", random_weights=True)`` (zero weights: latency does not
depend on them, the kernels having no slow path for all-zero data) with the
reference's shipped settings: 4 steps at strength 0.8 (3 run), CFG 1.5,
ControlNet scale 0.5.  Phases, in order; any failure raises and the run
exits non-zero:

1. Latency: CFG 1.5 and guidance 1.0 (the reference notebook's setting)
   edits in turns, ``--reps`` each after a warm-up and a throwaway each
   (fresh prompts, so prompt encoding is in), median with min and max.
2. Throughput: a pipelined batch-4 run of 8 chunks, as a sweep runs it:
   ``stage_inputs`` on a loader thread for chunk i + 1 while chunk i
   computes, ``edit_batch_async``, chunk i's images read back while chunk
   i + 1 is dispatched; the median of the deltas between chunks after the
   first.
3. Device-only: the edit on inputs already on the card (``stage_inputs``)
   with prompts cached, synchronised, without the readback and the PIL
   work: batch 4 and both CFG arms at batch 1.
4. Stages: device ms per stage (the editor's CUDA events around prompt
   encoding, prepare and each graph replay) over edits with new prompts;
   the upload of one image (``upload_ms``).
5. SDXL: end to end and device-only.

Beside those keys it records the card's name and power limit, every
kernel flag's resolved value per stage, kernel launches per edit on the
eager arm (``flags.override(cuda_graphs=False)``: a replay makes no Python
call, so the wrappers' counters read only eager edits), device kernels and
their device ms per edit on both arms and per prompt encoding
(``torch.profiler``), each graph key's pool and the peak GiB.  MFU is against the H100's dense bf16 peak, 989 TFLOP/s, with the
FLOPs of ``utils/flops.py``; ``device_seconds_per_edit`` is the base.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from PIL import Image

H100_BF16_PEAK_TFLOPS = 989.0
BASELINE_S = 6.0  # the reference's headline seconds per image (BASELINE.md)
EDIT_KW = dict(strength=0.8, num_inference_steps=4, guidance_scale=1.5,
               controlnet_conditioning_scale=0.5)
NCHUNKS = 8


def log(*args) -> None:
    print("[bench]", *args, file=sys.stderr, flush=True)


def warm_card(seconds: float = 0.02) -> None:
    """Keep the card busy for ``seconds`` first: an idle H100 runs at 345 MHz."""
    x = torch.ones((4096, 4096), device="cuda", dtype=torch.bfloat16)
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        x @ x
        torch.cuda.synchronize()


def spread(values: list) -> dict:
    return dict(median=float(np.median(values)), min=float(min(values)),
                max=float(max(values)), all=[float(v) for v in values])


def timed_s(fn) -> float:
    """Host seconds of ``fn()`` to the end of the card's work."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def resolved_flags() -> dict:
    """Every kernel flag's value in each stage (and outside one)."""
    from fastedit_tpu_torch.ops import flags

    out = {}
    for stage in (None, *flags.STAGES):
        ctx = flags.stage(stage) if stage else flags.override()
        with ctx:
            out[stage or "outside"] = dict(
                use_cuda_conv=flags.use_cuda_conv(), use_fused_resnet=flags.use_fused_resnet(),
                use_fused_up2=flags.use_fused_up2(), use_fused_down2=flags.use_fused_down2(),
                use_cuda_attention=flags.use_cuda_attention(),
                use_cuda_groupnorm=flags.use_cuda_groupnorm(),
                cuda_graphs=flags.use_cuda_graphs())
    return out


def device_kernels(fn) -> tuple[int, float]:
    """(device kernels, their device ms) of one call of ``fn``, by
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.count for e in events),
            sum(getattr(e, "self_device_time_total", 0) for e in events) / 1e3)


def images(rng, n: int, r: int) -> list:
    return [Image.fromarray(rng.integers(0, 255, (r, r, 3), dtype=np.uint8)) for _ in range(n)]


def latency(editor, img, reps: int) -> dict:
    """Phase 1: CFG and guidance-1 edits in turns, each after its warm-up
    (the capture) and a throwaway."""
    for i, g in ((0, 1.5), (0, 1.0), (99, 1.5), (99, 1.0)):
        t = timed_s(lambda: editor.edit(img, f"warmup {i} {g}", seed=i,
                                        **{**EDIT_KW, "guidance_scale": g}))
        log(f"warm-up guidance {g} seed {i}: {t:.3f} s")
    cfg, nocfg = [], []
    for i in range(reps):
        cfg.append(timed_s(lambda: editor.edit(img, f"a rusty bicycle on a beach {i}", seed=i,
                                               **EDIT_KW)))
        nocfg.append(timed_s(lambda: editor.edit(img, f"a rusty bicycle {i} nocfg", seed=i,
                                                 **{**EDIT_KW, "guidance_scale": 1.0})))
    log("per-edit s, cfg:", [round(x, 4) for x in cfg], "guidance 1:",
        [round(x, 4) for x in nocfg])
    return dict(cfg=spread(cfg), nocfg=spread(nocfg))


def pipelined_batch4(editor, chunk_u8: np.ndarray) -> dict:
    """Phase 2: the sweep's lag-1 pipeline over NCHUNKS chunks of 4."""
    editor.edit_batch(chunk_u8, [f"warmup batch prompt {j}" for j in range(4)], seed=0,
                      **EDIT_KW)  # the batch-4 capture
    torch.cuda.synchronize()
    stager = ThreadPoolExecutor(max_workers=1, thread_name_prefix="stage")
    try:
        t0 = time.perf_counter()
        marks, pending = [], None
        staged = stager.submit(editor.stage_inputs, chunk_u8)
        for i in range(NCHUNKS):
            inputs = staged.result()
            if i + 1 < NCHUNKS:
                staged = stager.submit(editor.stage_inputs, chunk_u8)
            handle = editor.edit_batch_async(
                inputs, [f"a prompt {i} variant {j}" for j in range(4)], seed=i, **EDIT_KW)
            if pending is not None:
                pending.result()
                marks.append(time.perf_counter() - t0)
            pending = handle
        pending.result()
        marks.append(time.perf_counter() - t0)
    finally:
        stager.shutdown()
    deltas = [b - a for a, b in zip(marks, marks[1:])]
    per_batch = float(np.median(deltas))
    log(f"pipelined batch-4 x{NCHUNKS}: first {marks[0]:.4f} s, deltas "
        f"{[round(d, 4) for d in deltas]} -> {per_batch:.4f} s/batch")
    return dict(first_chunk_s=marks[0], chunk_deltas_s=deltas, seconds_per_batch=per_batch,
                edits_per_min=4 * 60.0 / per_batch)


def device_edit_s(editor, staged, prompts: list, guidance: float, seed: int) -> float:
    """Phase 3: seconds of one edit on a staged batch with its prompts
    cached, to the end of the card's work; no readback, no PIL."""
    return timed_s(lambda: editor._run_edit(
        staged, prompts, "", EDIT_KW["strength"], EDIT_KW["num_inference_steps"], guidance,
        EDIT_KW["controlnet_conditioning_scale"], 100, 200, seed, tile_noise=True))


def stage_times(editor, img, reps: int) -> dict:
    """Phase 4: device ms per stage over ``reps`` edits with new prompts,
    and the upload of one image."""
    ms = {}
    for i in range(reps):
        editor.edit(img, f"a rusty bicycle stage {i}", seed=i, **EDIT_KW)
        for k, v in editor.stage_ms().items():
            ms.setdefault(k, []).append(v)
    u8 = np.asarray(img, dtype=np.uint8)[None]
    upload = [1e3 * timed_s(lambda: editor.stage_inputs(u8)) for _ in range(reps)]
    return dict(stage_ms={k: spread(v) for k, v in ms.items()}, upload_ms=spread(upload))


def launches_per_edit(editor, img) -> dict:
    """Kernel launches per edit by the wrappers' counters on the eager arm;
    device kernels and their device ms per edit on both arms, and of the
    encoding of one new prompt (``torch.profiler``)."""
    from fastedit_tpu_torch.ops import flags
    from fastedit_tpu_torch.tools.inventory import launch_counts

    def edit():
        editor.edit(img, "a launch count prompt", seed=0, **EDIT_KW)

    edit()  # prompt cached, graphs captured
    with flags.override(cuda_graphs=False):
        edit()
        before = launch_counts()
        edit()
        after = launch_counts()
        eager = device_kernels(edit)
    graphs = device_kernels(edit)
    prompt = device_kernels(lambda: editor._encode_prompts(["a new prompt to encode"]))
    return dict(kernel_launches_eager={k: after[k] - before[k] for k in after},
                device_kernels_eager=eager[0], device_ms_eager=eager[1],
                device_kernels_graphs=graphs[0], device_ms_graphs=graphs[1],
                prompt_encode_kernels=prompt[0], prompt_encode_device_ms=prompt[1])


def sdxl(img, reps: int) -> dict:
    """Phase 5: SDXL end to end and device-only."""
    from fastedit_tpu_torch import FastEditor

    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    editor = FastEditor("sdxl", random_weights=True)
    log(f"sdxl editor built in {time.perf_counter() - t:.1f} s")
    log(f"sdxl warm-up (capture) {timed_s(lambda: editor.edit(img, 'warmup sdxl', seed=0, **EDIT_KW)):.2f} s")
    editor.edit(img, "throwaway sdxl", seed=99, **EDIT_KW)
    e2e = [timed_s(lambda: editor.edit(img, f"a rusty bicycle {i} sdxl", seed=i, **EDIT_KW))
           for i in range(reps)]
    prompt = "a rusty bicycle on a beach"
    editor._encode_prompts([prompt, ""])
    staged = editor.stage_inputs(np.asarray(img, np.uint8)[None])
    device_edit_s(editor, staged, [prompt], 1.5, 0)  # burn-in
    dev = spread([device_edit_s(editor, staged, [prompt], 1.5, i) for i in range(reps)])
    log("sdxl per-edit s:", [round(x, 4) for x in e2e], "device-only:", dev)
    out = dict(e2e=spread(e2e), device=dev, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               graph_pool_gib={str(k[:5]): c.pool_bytes / 2**30
                               for k, c in editor._graphs.captured.items()})
    del editor
    torch.cuda.empty_cache()
    return out


def run(reps: int) -> dict:
    from fastedit_tpu_torch import FastEditor
    from fastedit_tpu_torch.models import configs as C
    from fastedit_tpu_torch.tools.timing import card_line
    from fastedit_tpu_torch.utils import flops as flops_lib

    if not torch.cuda.is_available():
        raise SystemExit("bench measures the card: no CUDA device")
    card = card_line()
    log(card, "|", torch.cuda.get_device_name(0), "| torch", torch.__version__,
        "cuda", torch.version.cuda)
    t = time.perf_counter()
    editor = FastEditor("ssd-1b", random_weights=True)
    log(f"ssd-1b editor built in {time.perf_counter() - t:.1f} s")
    r = editor.resolution
    rng = np.random.default_rng(0)
    img = images(rng, 1, r)[0]
    warm_card()
    torch.cuda.reset_peak_memory_stats()

    lat = latency(editor, img, reps)
    chunk_u8 = np.stack([np.asarray(im, dtype=np.uint8) for im in images(rng, 4, r)])
    batch = pipelined_batch4(editor, chunk_u8)

    prompts4 = [f"a device ceiling prompt {j}" for j in range(4)]
    prompt = "a rusty bicycle on a beach"
    editor._encode_prompts(prompts4 + [prompt, ""])
    staged4 = editor.stage_inputs(chunk_u8)
    staged1 = editor.stage_inputs(np.asarray(img, np.uint8)[None])
    for staged, prompts, g in ((staged4, prompts4, 1.5), (staged1, [prompt], 1.5),
                               (staged1, [prompt], 1.0)):
        device_edit_s(editor, staged, prompts, g, 0)  # burn-in
    dev_b4 = spread([device_edit_s(editor, staged4, prompts4, 1.5, i) for i in range(reps)])
    dev_cfg, dev_nocfg = [], []
    for i in range(reps):  # the two CFG arms in turns
        dev_cfg.append(device_edit_s(editor, staged1, [prompt], 1.5, i))
        dev_nocfg.append(device_edit_s(editor, staged1, [prompt], 1.0, i))
    dev_cfg, dev_nocfg = spread(dev_cfg), spread(dev_nocfg)
    log("device-only s: batch 4", dev_b4, "cfg", dev_cfg, "guidance 1", dev_nocfg)

    stages = stage_times(editor, img, reps)
    log("stage ms:", {k: round(v["median"], 3) for k, v in stages["stage_ms"].items()},
        "upload ms", round(stages["upload_ms"]["median"], 3))
    launches = launches_per_edit(editor, img)
    log("launches per edit:", launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    pools = {str(k[:5]): c.pool_bytes / 2**30 for k, c in editor._graphs.captured.items()}
    del editor, staged4, staged1
    torch.cuda.empty_cache()
    xl = sdxl(img, reps)

    flops = flops_lib.edit_flops(C.SSD1B_UNET, C.SDXL_CONTROLNET_SMALL, C.SDXL_VAE,
                                 resolution=r, num_steps_run=3, do_cfg=True)
    xl_flops = flops_lib.edit_flops(C.SDXL_UNET, C.SDXL_CONTROLNET_SMALL, C.SDXL_VAE,
                                    resolution=r, num_steps_run=3, do_cfg=True)
    value, device_s = lat["cfg"]["median"], dev_cfg["median"]
    achieved = flops / device_s / 1e12
    return {
        "metric": "seconds_per_1024px_4step_edit",
        "value": value,
        "unit": "s",
        "vs_baseline": BASELINE_S / value,
        "device_seconds_per_edit": device_s,
        "seconds_per_edit_guidance1_notebook_cfg": lat["nocfg"]["median"],
        "device_seconds_per_edit_guidance1": dev_nocfg["median"],
        "edits_per_min_per_chip_batch4": batch["edits_per_min"],
        "edits_per_min_per_chip_batch4_device": 4 * 60.0 / dev_b4["median"],
        "flops_per_edit_tf": flops / 1e12,
        "achieved_tflops_device": achieved,
        "mfu_pct_device": 100.0 * achieved / H100_BF16_PEAK_TFLOPS,
        "stage_ms_device_isolated": {k: v["median"] for k, v in stages["stage_ms"].items()},
        "upload_ms": stages["upload_ms"]["median"],
        "sdxl_seconds_per_edit": xl["e2e"]["median"],
        "sdxl_device_seconds_per_edit": xl["device"]["median"],
        "sdxl_achieved_tflops_device": xl_flops / xl["device"]["median"] / 1e12,
        "card": card,
        "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "reps": reps,
        "flags_by_stage": resolved_flags(),
        "launches_per_edit": launches,
        "peak_gib": peak_gib,
        "graph_pool_gib": pools,
        "sdxl_peak_gib": xl["peak_gib"],
        "sdxl_graph_pool_gib": xl["graph_pool_gib"],
        "spread": dict(cfg=lat["cfg"], nocfg=lat["nocfg"], device_cfg=dev_cfg,
                       device_nocfg=dev_nocfg, device_batch4=dev_b4, batch4=batch,
                       stage_ms=stages["stage_ms"], upload_ms=stages["upload_ms"],
                       sdxl=xl["e2e"], sdxl_device=xl["device"]),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=6,
                    help="timed edits per arm and phase (the JAX bench: 6, device-only 5)")
    args = ap.parse_args(argv)
    if args.reps < 1:
        ap.error("--reps must be >= 1")
    record = run(args.reps)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
