"""Time the GroupNorm kernel (and its statistics launch alone) of one tree of
this repository on the card.

    python fastedit_tpu_torch/tools/groupnorm_bench.py [--root DIR] [--out FILE]
        [--dtype bf16|fp32]

``--root`` is the checkout whose ``fastedit_tpu_torch`` is imported (default:
the one this file lies in), so two trees can be read in one run on one card,
in turns: unpack the other tree with ``git archive`` and pass its directory.
Shapes come from the SSD-1B edit path at 1024², batch 1, as the kernel
plan routes it (``tools/inventory.kernel_calls``): every ``ops.group_norm``
call the GroupNorm kernel takes, and every GroupNorm statistics call of a
fused resnet block (``group_norm_scale_shift``: the VAE decoder's).
Per shape it prints the device milliseconds of the kernel from a CUDA graph
of 20 calls (``graph_ms``) and eagerly (10 back-to-back calls), the plain
version's (eager), ``F.group_norm`` (+ ``F.silu``) from a graph, and the
bound (one read of x, one write of the output, at 3.35 TB/s); then the sums
over one edit's calls.  Where a tree has no statistics kernel, only the plain
version is timed.  ``--dtype fp32`` reads the kernels' fp32 instances on
fp32 inputs at the same shapes, with the fp32 edit's call counts, and each
row carries its plan's route.  One JSON object, also
written to ``--out``.  It needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path


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
    from timing import PEAK_HBM_BYTES_PER_S, graph_ms, time_ms  # this tree's, whichever --root

    sys.path.insert(0, str(Path(args.root).resolve()))
    from fastedit_tpu_torch.models import configs as C
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
    calls = inventory.kernel_calls(sites, dtype=dtype)
    gn_calls, ss_calls = (Counter({key: c for (k, key), c in calls.items() if k == kernel + sfx})
                          for kernel in ("group_norm", "group_norm_scale_shift"))
    has_ss = hasattr(fg, "group_norm_scale_shift")
    plain_ss = getattr(gn, "group_norm_scale_shift_plain", gn.group_norm_scale_shift)
    gen = torch.Generator(device="cuda").manual_seed(0)

    rows = []
    for kind, keys in (("group_norm", gn_calls), ("group_norm_scale_shift", ss_calls)):
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
                calls=(gn_calls if kind == "group_norm" else ss_calls)[key],
            )
            rows.append(row)
            print(kind, list(key), {k: v for k, v in row.items() if k not in ("kernel", "shape")},
                  flush=True)
            del x, x_nchw

    per_edit = {}
    for row in rows:
        count = row["calls"]
        for field in ("ms", "eager_ms", "plain_ms", "library_ms", "bound_ms"):
            if row.get(field) is not None:
                k = f"{row['kernel']}_{field}"
                per_edit[k] = per_edit.get(k, 0.0) + count * row[field]
        k = f"{row['kernel']}_calls"
        per_edit[k] = per_edit.get(k, 0) + count
        if row.get("route") and row.get("ms") is not None:  # the split by route
            for field, v in (("ms", count * row["ms"]), ("calls", count)):
                k = f"{row['kernel']}_{row['route']}_{field}"
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
