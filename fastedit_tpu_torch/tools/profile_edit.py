"""Where an edit's device time goes: ``torch.profiler`` over ``edit()`` on the card.

    python -m fastedit_tpu_torch.tools.profile_edit [--model ssd-1b] [--edits 2] [--json PATH]

Builds ``FastEditor(model, random_weights=True)`` on the card in the
default kernel configuration, runs one warm-up edit, times ``--edits``
edits on the host clock (and each stage with CUDA events), then runs as
many again under the profiler (CUDA activity only).  Prints the card's name
and power limit, seconds per edit, device ms per stage, the device's busy
share (profiled kernel time over the unprofiled wall time), device ms per
edit by category and the top kernels; ``--json`` also writes them to a
file.

Categories come from kernel names: each of this package's CUDA kernels
(the conv kernels of ``csrc/conv3x3.cu`` one by one, flash attention, the
GroupNorm kernel's launches), cuDNN convolutions (stems, the VAE encoder's
convs and convs outside the kernels' gates), cuBLAS / CUTLASS GEMMs
(linears and 1x1 convs), softmax (attention outside the flash kernel's
gate), reductions (norm statistics), elementwise and copy kernels.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
from PIL import Image

CATEGORIES = (  # first match wins
    ("conv3x3 kernel (csrc/conv3x3.cu)", ("conv3x3_kernel",)),
    ("fused resnet conv kernel (csrc/conv3x3.cu)", ("conv3x3_fused_kernel",)),
    ("up2 conv kernel (csrc/conv3x3.cu)", ("conv3x3_up2_kernel", "up2_phase_weights_kernel")),
    ("down2 conv kernel (csrc/conv3x3.cu)", ("conv3x3_down2_kernel",)),
    ("GroupNorm kernel (csrc/group_norm.cu)", ("gn_partial_kernel", "gn_finalize_kernel",
                                               "gn_apply_kernel")),
    ("flash attention kernel (csrc/flash_attention.cu)", ("flash_d64_kernel",
                                                          "flash_d512_kernel")),
    ("cuDNN conv", ("conv", "fprop", "cudnn", "implicit_gemm")),
    ("GEMM (cuBLAS)", ("gemm", "xmma", "cutlass", "cublas", "matmul", "nvjet")),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce",)),
    ("copy / layout", ("copy", "memcpy", "memset", "cat", "index", "gather", "scatter")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


class StageTimer:
    """Wraps the pipeline's stage functions with CUDA events, so each
    edit's device time per stage can be read after it returns."""

    STAGES = ("encode_prompt", "prepare", "vae_sample", "denoise", "vae_decode")

    def __init__(self):
        from fastedit_tpu_torch.pipeline import stages

        self.stages = stages
        self.events = []
        self.last_latents = None
        self._orig = {name: getattr(stages, name) for name in self.STAGES}
        for name, fn in self._orig.items():
            setattr(stages, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def timed(*args, **kwargs):
            if name == "vae_decode":
                self.last_latents = args[1].float().clone()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events.append((name, start, end))
            return out

        return timed

    def take(self) -> dict:
        """Device ms per stage since the last call (the edit has returned,
        so its events have completed)."""
        ms = {}
        for name, start, end in self.events:
            end.synchronize()
            ms[name] = ms.get(name, 0.0) + start.elapsed_time(end)
        self.events = []
        return ms

    def remove(self):
        for name, fn in self._orig.items():
            setattr(self.stages, name, fn)


def category(kernel_name: str) -> str:
    n = kernel_name.lower()
    for cat, keys in CATEGORIES:
        if any(k in n for k in keys):
            return cat
    return "other"


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", None) or evt.self_cuda_time_total


def profile(model: str, edits: int) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from fastedit_tpu_torch import FastEditor

    if not torch.cuda.is_available():
        raise SystemExit("profile_edit measures the card: no CUDA device")
    editor = FastEditor(model, random_weights=True)
    r = editor.resolution
    rng = np.random.default_rng(0)
    image = Image.fromarray(rng.integers(0, 256, (r, r, 3), dtype=np.uint8), "RGB")
    kw = dict(strength=0.8, num_inference_steps=4, guidance_scale=1.5)
    editor.edit(image, "a prompt", seed=0, **kw)  # warm-up: kernels built, prompts cached
    torch.cuda.synchronize()
    timer = StageTimer()
    stage_ms = defaultdict(float)
    wall_s = 0.0  # wall time without the profiler's overhead
    for i in range(edits):
        t0 = time.perf_counter()
        editor.edit(image, "a prompt", seed=i, **kw)
        wall_s += time.perf_counter() - t0
        for name, ms in timer.take().items():
            stage_ms[name] += ms / edits
    timer.remove()

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(edits):
            editor.edit(image, "a prompt", seed=i, **kw)
        torch.cuda.synchronize()

    kernels = defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and _device_us(evt) > 0:
            kernels[evt.key][0] += _device_us(evt) / 1e3 / edits
            kernels[evt.key][1] += evt.count // edits
    by_cat = defaultdict(float)
    for name, (ms, _) in kernels.items():
        by_cat[category(name)] += ms
    device_ms = sum(by_cat.values())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]
    return dict(
        card=card, model=model, resolution=r, edits=edits,
        seconds_per_edit=wall_s / edits, stage_ms_per_edit=dict(stage_ms),
        device_ms_per_edit=device_ms,
        device_busy_share=device_ms / (1e3 * wall_s / edits),
        ms_per_edit_by_category=dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
        top_kernels=[dict(name=n[:160], category=category(n), ms_per_edit=ms,
                          launches_per_edit=c) for n, (ms, c) in top],
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="ssd-1b", choices=["ssd-1b", "sdxl"])
    ap.add_argument("--edits", type=int, default=2)
    ap.add_argument("--json", default=None, help="also write the result to this file")
    args = ap.parse_args(argv)
    res = profile(args.model, args.edits)
    print(res["card"])
    print(f"{res['model']} at {res['resolution']}²: {res['seconds_per_edit']:.4f} s/edit, "
          f"device busy {res['device_ms_per_edit']:.2f} ms/edit "
          f"({100 * res['device_busy_share']:.1f}% of wall)")
    print("  stage ms per edit:", {k: round(v, 3) for k, v in res["stage_ms_per_edit"].items()})
    for cat, ms in res["ms_per_edit_by_category"].items():
        print(f"  {ms:9.3f} ms  {cat}")
    for k in res["top_kernels"]:
        print(f"  {k['ms_per_edit']:9.3f} ms  x{k['launches_per_edit']:<5d} {k['name'][:100]}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
