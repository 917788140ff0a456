"""Time the GroupNorm kernel (and its statistics launch alone) of one tree of
this repository on the card.

    python fastedit_tpu_torch/tools/groupnorm_bench.py [--root DIR] [--out FILE]
        [--dtype bf16|fp32]

``--root`` is the checkout whose ``fastedit_tpu_torch`` is imported (default:
the one this file lies in), so two trees can be read in one run on one card,
in turns: unpack the other tree with ``git archive`` and pass its directory.
Shapes come from the SSD-1B edit path at 1024², batch 1: every
``ops.group_norm`` call the GroupNorm kernel takes in the opt-in
configuration (``use_cuda_conv=True, use_cuda_groupnorm=True``) and with
only ``use_cuda_groupnorm=True``; and every GroupNorm statistics call of a
fused resnet block (``group_norm_scale_shift``), in the default
configuration (the VAE decoder) and in the opt-in one (also the encoder).
Per shape it prints the device milliseconds of the kernel from a CUDA graph
of 20 calls (``graph_ms``) and eagerly (10 back-to-back calls), the plain
version's (eager), ``F.group_norm`` (+ ``F.silu``) from a graph, and the
bound (one read of x, one write of the output, at 3.35 TB/s); then the sums
over one edit's calls.  Where a tree has no statistics kernel, only the plain
version is timed.  ``--dtype fp32`` reads the kernels' fp32 instances on
fp32 inputs at the same shapes, with the fp32 edit's call counts (the default
configuration), and each row carries its plan's route.  One JSON object, also
written to ``--out``.  It needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

PEAK_HBM_BYTES_PER_S = 3.35e12


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--out", default=None)
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("groupnorm_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from timing import graph_ms, time_ms  # this tree's, whichever tree --root names

    sys.path.insert(0, str(Path(args.root).resolve()))
    from fastedit_tpu_torch.models import configs as C
    from fastedit_tpu_torch.ops import flags
    from fastedit_tpu_torch.ops import fused_groupnorm as fg
    from fastedit_tpu_torch.ops import groupnorm as gn
    from fastedit_tpu_torch.tools import inventory

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    sites = inventory.edit_sites(C.SSD1B_UNET, C.SDXL_CONTROLNET_SMALL, C.SDXL_VAE, 1024,
                                 batch=1, steps=3)
    f32 = args.dtype == "fp32"
    dtype, isz, sfx = (torch.float32, 4, "_f32") if f32 else (torch.bfloat16, 2, "")
    configs = {"default": {}} if f32 else {
        "optin": dict(use_cuda_conv=True, use_cuda_groupnorm=True),
        "gn_on": dict(use_cuda_groupnorm=True), "default": {}}
    gn_calls, ss_calls = {}, {}
    for name, override in configs.items():
        with flags.override(**override):
            calls = inventory.kernel_calls(sites, dtype=dtype)
        gn_calls[name] = Counter({key: c for (k, key), c in calls.items()
                                  if k == "group_norm" + sfx})
        ss = Counter()  # the statistics of each fused resnet block's two prologues
        for (stage, op, key), c in sites.items():
            with flags.override(**override), inventory.stage_context(stage):
                if op == "resnet" and flags.use_fused_resnet():
                    n, h, w, cin, cout, groups, _ = key
                    ss[(n, h, w, cin, groups)] += c
                    ss[(n, h, w, cout, groups)] += c
        ss_calls[name] = ss
    has_ss = hasattr(fg, "group_norm_scale_shift")
    plain_ss = getattr(gn, "group_norm_scale_shift_plain", gn.group_norm_scale_shift)
    gen = torch.Generator(device="cuda").manual_seed(0)

    rows = []
    for kind, keys in (("group_norm", set().union(*gn_calls.values())),
                       ("group_norm_scale_shift", set().union(*ss_calls.values()))):
        for key in sorted(keys, key=str):
            n, h, w, c, groups = key[:5]
            act = key[5] if kind == "group_norm" else None
            x = (torch.randn((n, h, w, c), generator=gen, device="cuda") * 2.0 + 0.5).to(dtype)
            gamma = torch.randn(c, generator=gen, device="cuda") * 0.5 + 1.0
            beta = torch.randn(c, generator=gen, device="cuda") * 0.2
            x_nchw, g_bf, b_bf = x.permute(0, 3, 1, 2), gamma.to(dtype), beta.to(dtype)
            elems = n * h * w * c
            row = dict(kernel=kind, shape=list(key), dtype=args.dtype)
            if hasattr(fg, "plan_for"):
                row["route"] = fg.plan_for(x, groups).route
            if kind == "group_norm":
                kern = lambda: fg.fused_group_norm(x, gamma, beta, groups, 1e-5, act)  # noqa
                plain = lambda: gn.group_norm_plain(x, gamma, beta, groups, 1e-5, act)  # noqa

                def library():
                    y = F.group_norm(x_nchw, groups, g_bf, b_bf, 1e-5)
                    return F.silu(y) if act == "silu" else y

                nbytes = 2.0 * isz * elems + 8.0 * c
                row.update(library_ms=graph_ms(library))
            else:
                kern = (lambda: fg.group_norm_scale_shift(x, gamma, beta, groups, 1e-5)) \
                    if has_ss else None
                plain = lambda: plain_ss(x, gamma, beta, groups, 1e-5)  # noqa
                nbytes = isz * elems + 8.0 * c + 8.0 * n * c
            row.update(
                bound_ms=1e3 * nbytes / PEAK_HBM_BYTES_PER_S, plain_ms=time_ms(plain),
                ms=graph_ms(kern) if kern else None, eager_ms=time_ms(kern) if kern else None,
                calls={name: (gn_calls if kind == "group_norm" else ss_calls)[name].get(key, 0)
                       for name in configs},
            )
            rows.append(row)
            print(kind, list(key), {k: v for k, v in row.items() if k not in ("kernel", "shape")},
                  flush=True)
            del x, x_nchw

    per_edit = {}
    for row in rows:
        for name, count in row["calls"].items():
            if not count:
                continue
            for field in ("ms", "eager_ms", "plain_ms", "library_ms", "bound_ms"):
                if row.get(field) is not None:
                    k = f"{row['kernel']}_{name}_{field}"
                    per_edit[k] = per_edit.get(k, 0.0) + count * row[field]
            k = f"{row['kernel']}_{name}_calls"
            per_edit[k] = per_edit.get(k, 0) + count
            if row.get("route") and row.get("ms") is not None:  # the split by route
                for field, v in (("ms", count * row["ms"]), ("calls", count)):
                    k = f"{row['kernel']}_{name}_{row['route']}_{field}"
                    per_edit[k] = per_edit.get(k, 0) + v
    result = dict(root=str(args.root), card=card, torch=torch.__version__, dtype=args.dtype,
                  ms_per_edit=per_edit, shapes=rows)
    print(json.dumps({k_: v for k_, v in result.items() if k_ != "shapes"}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
