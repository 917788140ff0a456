"""Where an edit's device time goes: ``torch.profiler`` over ``edit()`` on the card.

    python -m fastedit_tpu_torch.tools.profile_edit [--model ssd-1b] [--edits 2]
        [--fp32] [--guidance 1.5] [--flags NAME=VALUE[,NAME=VALUE...]]... [--json PATH]

Builds ``FastEditor(model, random_weights=True)`` on the card (with ``--fp32``
the fp32 editor, ``use_full_precision=True``: every kernel call on its fp32
instance, TF32 off), runs one
warm-up edit per arm (which captures the arm's CUDA graphs), times
``--edits`` edits per arm on the host clock (and each stage with the
editor's CUDA events, ``FastEditor.stage_ms``), then runs as many again per
arm, each under a profiler of its own (CUDA activity only), which sees the
kernels a graph replays as it sees eager ones.  An arm is a setting of
the two kernel flags (``ops/flags.KernelFlags``): each ``--flags`` gives one,
with values 1 or 0 (``--flags cuda_graphs=0`` is the eager arm, the graphs'
launches made one by one from the host; ``--flags plain_versions=1`` runs
every kernel's plain version); without ``--flags`` the one arm is the
default, graphs on.  The arms take turns, edit by edit, in one process.
Per arm it prints seconds per edit and device ms per edit (median, min and
max over the edits), kernel launches per edit, device ms per stage, the
device's busy share (median profiled kernel time over median unprofiled wall
time), device ms per edit by category and the top kernels, after the card's
name and power limit; ``--json`` also writes them to a file.

Categories come from kernel names: each of this package's CUDA kernels
(the conv kernels of ``csrc/conv3x3.cu`` one by one, flash attention, the
GroupNorm kernel's launches; their fp32 instances: the 3xTF32 stride-1,
fused, up2 and stride-2 convs and D = 64 and D = 512 attention with their
TF32 splits), cuDNN convolutions (stems, the VAE encoder's
convs and convs outside the kernels' gates), cuBLAS / CUTLASS GEMMs
(linears and 1x1 convs), softmax (attention outside the flash kernel's
gate), reductions (norm statistics), elementwise and copy kernels.
"""

from __future__ import annotations

import argparse
import json
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
    ("GroupNorm kernel (csrc/group_norm.cu)", ("gn_kernel",)),
    ("flash attention kernel (csrc/flash_attention.cu)", ("flash_d64_kernel",
                                                          "flash_d512_kernel")),
    ("fp32 fused resnet conv kernel, 3xTF32 (csrc/conv3x3_tf32x3.cu)",
     ("conv3x3_fused_tf32x3_kernel",)),
    ("fp32 up2 conv kernel, 3xTF32 (csrc/conv3x3_tf32x3.cu)", ("conv3x3_up2_tf32x3_kernel",)),
    ("fp32 conv kernel, 3xTF32 (csrc/conv3x3_tf32x3.cu)",
     ("conv3x3_tf32x3_kernel", "split_tf32_kernel")),
    ("fp32 down2 conv kernel, 3xTF32 (csrc/conv3x3_tf32x3.cu)", ("conv3x3_down2_tf32x3_kernel",)),
    ("fp32 flash attention D = 64, 3xTF32 (csrc/flash_attention_tf32x3.cu)",
     ("flash_d64_tf32x3_kernel", "split_qkv_tf32_kernel")),
    ("fp32 flash attention D = 512, 3xTF32 (csrc/flash_attention_tf32x3.cu)",
     ("flash_d512_tf32x3_kernel",)),
    ("cuDNN conv", ("conv", "fprop", "cudnn", "implicit_gemm")),
    ("GEMM (cuBLAS)", ("gemm", "xmma", "cutlass", "cublas", "matmul", "nvjet")),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce",)),
    ("copy / layout", ("copy", "memcpy", "memset", "cat", "index", "gather", "scatter")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def category(kernel_name: str) -> str:
    n = kernel_name.lower()
    for cat, keys in CATEGORIES:
        if any(k in n for k in keys):
            return cat
    return "other"


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", None) or evt.self_cuda_time_total


def parse_flags(spec: str) -> dict:
    """``"cuda_graphs=0,plain_versions=1"`` -> flag overrides."""
    from fastedit_tpu_torch.ops import flags

    values = {"1": True, "0": False, "true": True, "false": False}
    out = {}
    for item in filter(None, spec.split(",")):
        name, _, value = item.partition("=")
        if not hasattr(flags.FLAGS, name) or value.lower() not in values:
            raise SystemExit(f"--flags: {item!r} is not NAME=1|0 for a field of "
                             "ops/flags.KernelFlags")
        out[name] = values[value.lower()]
    return out


def _spread(values: list) -> dict:
    return dict(median=float(np.median(values)), min=float(min(values)),
                max=float(max(values)), all=[float(v) for v in values])


def profile(model: str, edits: int, arms=None, fp32: bool = False,
            guidance: float = 1.5) -> dict:
    """One result per arm (a dict of flag overrides), keyed by its spec;
    ``fp32``: the fp32 editor; ``guidance``: 1.0 runs without CFG."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from fastedit_tpu_torch import FastEditor
    from fastedit_tpu_torch.ops import flags
    from fastedit_tpu_torch.tools.timing import card_line

    if not torch.cuda.is_available():
        raise SystemExit("profile_edit measures the card: no CUDA device")
    arms = arms or {"default": {}}
    editor = FastEditor(model, random_weights=True, use_full_precision=fp32)
    r = editor.resolution
    rng = np.random.default_rng(0)
    image = Image.fromarray(rng.integers(0, 256, (r, r, 3), dtype=np.uint8), "RGB")
    kw = dict(strength=0.8, num_inference_steps=4, guidance_scale=guidance)
    for override in arms.values():  # warm-up: kernels built, graphs captured, prompts cached
        with flags.override(**override):
            editor.edit(image, "a prompt", seed=0, **kw)
    torch.cuda.synchronize()
    wall = {name: [] for name in arms}  # wall time without the profiler's overhead
    stage_ms = {name: defaultdict(float) for name in arms}
    for i in range(edits):
        for name, override in arms.items():
            with flags.override(**override):
                t0 = time.perf_counter()
                editor.edit(image, "a prompt", seed=i, **kw)
                wall[name].append(time.perf_counter() - t0)
            for stage, ms in editor.stage_ms().items():
                stage_ms[name][stage] += ms / edits

    device = {name: [] for name in arms}
    launches = {name: [] for name in arms}
    kernels = {name: defaultdict(lambda: [0.0, 0]) for name in arms}
    for i in range(edits):
        for name, override in arms.items():
            with flags.override(**override), \
                    torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                editor.edit(image, "a prompt", seed=i, **kw)
                torch.cuda.synchronize()
            ms = n = 0
            for evt in prof.key_averages():
                if evt.device_type == torch.autograd.DeviceType.CUDA and _device_us(evt) > 0:
                    kernels[name][evt.key][0] += _device_us(evt) / 1e3 / edits
                    kernels[name][evt.key][1] += evt.count
                    ms += _device_us(evt) / 1e3
                    n += evt.count
            device[name].append(ms)
            launches[name].append(n)
    card = card_line()
    results = {}
    for name in arms:
        by_cat = defaultdict(float)
        for kname, (ms, _) in kernels[name].items():
            by_cat[category(kname)] += ms
        top = sorted(kernels[name].items(), key=lambda kv: -kv[1][0])[:25]
        results[name] = dict(
            card=card, model=model, resolution=r, edits=edits, flags=arms[name],
            dtype="fp32" if fp32 else "bf16", guidance_scale=guidance,
            seconds_per_edit=_spread(wall[name]), stage_ms_per_edit=dict(stage_ms[name]),
            device_ms_per_edit=_spread(device[name]),
            launches_per_edit=_spread(launches[name]),
            device_busy_share=float(np.median(device[name])) / (1e3 * float(np.median(wall[name]))),
            ms_per_edit_by_category=dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
            top_kernels=[dict(name=n[:160], category=category(n), ms_per_edit=ms,
                              launches_per_edit=c / edits) for n, (ms, c) in top],
        )
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="ssd-1b", choices=["ssd-1b", "sdxl"])
    ap.add_argument("--edits", type=int, default=2)
    ap.add_argument("--fp32", action="store_true",
                    help="the fp32 editor (use_full_precision=True): the quality mode's kernels")
    ap.add_argument("--guidance", type=float, default=1.5,
                    help="guidance scale; 1.0 runs without CFG")
    ap.add_argument("--flags", action="append", default=None,
                    help="one arm's flag overrides, NAME=1|0[,...]; repeat for more arms")
    ap.add_argument("--json", default=None, help="also write the result to this file")
    args = ap.parse_args(argv)
    arms = {spec: parse_flags(spec) for spec in args.flags} if args.flags else None
    results = profile(args.model, args.edits, arms, args.fp32, args.guidance)
    print(next(iter(results.values()))["card"])
    for name, res in results.items():
        sec, dev, n = (res[k] for k in ("seconds_per_edit", "device_ms_per_edit",
                                        "launches_per_edit"))
        print(f"[{name}] {res['model']} {res['dtype']} at {res['resolution']}², guidance "
              f"{res['guidance_scale']}, {res['edits']} edits: "
              f"{sec['median']:.4f} s/edit ({sec['min']:.4f}-{sec['max']:.4f}), device busy "
              f"{dev['median']:.2f} ms/edit ({dev['min']:.2f}-{dev['max']:.2f}, "
              f"{100 * res['device_busy_share']:.1f}% of wall), "
              f"{n['median']:.0f} launches/edit ({n['min']:.0f}-{n['max']:.0f})")
        print("  stage ms per edit:",
              {k: round(v, 3) for k, v in res["stage_ms_per_edit"].items()})
        for cat, ms in res["ms_per_edit_by_category"].items():
            print(f"  {ms:9.3f} ms  {cat}")
        for k in res["top_kernels"]:
            print(f"  {k['ms_per_edit']:9.3f} ms  x{k['launches_per_edit']:<7.1f} "
                  f"{k['name'][:100]}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
