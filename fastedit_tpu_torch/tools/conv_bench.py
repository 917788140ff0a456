"""Time the four conv kernels of one tree of this repository on the card.

    python fastedit_tpu_torch/tools/conv_bench.py [--root DIR] [--out FILE]

``--root`` is the checkout whose ``fastedit_tpu_torch`` is imported (default:
the one this file lies in), so two trees can be read in one run on one card,
in turns: unpack the other tree with ``git archive`` and pass its directory.
For every shape the SSD-1B edit path at 1024² (batch 1, default kernel
configuration, ``tools/inventory.py`` of that tree) gives ``conv3x3``,
``conv3x3_fused``, ``conv3x3_up2`` and ``conv3x3_down2``, it prints the mean
device milliseconds of 10 back-to-back calls (CUDA events), the same from a
CUDA graph of 20 calls (``graph_ms``: the device alone, where a call is
shorter than the host takes to enqueue it) and the achieved TFLOP/s of the
latter, then each kernel's sums over one edit's calls, and the host's
microseconds per ``conv3x3`` call at the smallest shape: the wall time of
200 calls up to the last call's return (what the host spends enqueueing:
checks, plan, tensor maps, launch) and up to one synchronise after it (the
larger of that and the device's time per call), the least of 7 such runs;
and the same for the library's C function called alone (tensor-map encoding
and launch, without the Python wrapper).  One JSON object, also written to
``--out``.  It needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("conv_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from timing import graph_ms, host_us, time_ms  # this tree's, whichever tree --root names

    sys.path.insert(0, str(Path(args.root).resolve()))
    from fastedit_tpu_torch.models import configs as C
    from fastedit_tpu_torch.ops import conv3x3 as k
    from fastedit_tpu_torch.ops import conv_fused as cf
    from fastedit_tpu_torch.ops.build import library
    from fastedit_tpu_torch.tools import inventory

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    sites = inventory.edit_sites(C.SSD1B_UNET, C.SDXL_CONTROLNET_SMALL, C.SDXL_VAE, 1024,
                                 batch=1, steps=3)
    calls = inventory.kernel_calls(sites)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def operands(n, h, w, cin, cout):
        x = torch.randn((n, h, w, cin), generator=gen, device="cuda").bfloat16()
        wt = torch.randn((cout, cin, 3, 3), generator=gen, device="cuda") * (9 * cin) ** -0.5
        wt = wt.bfloat16().contiguous(memory_format=torch.channels_last)
        return x, wt, torch.randn(cout, generator=gen, device="cuda") * 0.1

    rows, per_edit = [], {}
    for (kernel, key), count in sorted(calls.items(), key=str):
        if not kernel.startswith("conv3x3"):
            continue
        n, h, w, cin, cout = key[:5]
        x, wt, bias = operands(n, h, w, cin, cout)
        flops = 2.0 * n * h * w * cout * 9 * cin
        if kernel == "conv3x3":
            fn = lambda: k.conv3x3(x, wt, bias)  # noqa: E731
        elif kernel == "conv3x3_fused":
            pre = (torch.rand((n, cin), generator=gen, device="cuda") + 0.5,
                   torch.randn((n, cin), generator=gen, device="cuda") * 0.5)
            pb = torch.randn((n, cout), generator=gen, device="cuda") * 0.1 if key[5] else bias
            skip = (torch.randn((n, h, w, cout), generator=gen, device="cuda").bfloat16()
                    if key[6] else None)
            fn = lambda: cf.conv3x3_fused(x, wt, pb, pre, skip=skip)  # noqa: E731
        elif kernel == "conv3x3_up2":
            flops = 32.0 * n * h * w * cin * cout
            folded = cf.fold_up2(wt)  # once, as the upsampler modules fold them
            fn = lambda: cf.conv3x3_up2(x, wt, bias, phases=folded)  # noqa: E731
        else:
            flops /= 4
            fn = lambda: cf.conv3x3_down2(x, wt, bias, asymmetric=key[5])  # noqa: E731
        ms, gms = time_ms(fn), graph_ms(fn)
        rows.append(dict(kernel=kernel, shape=list(key), calls_edit=count, ms=ms, graph_ms=gms,
                         tflops=flops / gms / 1e9))
        per_edit[kernel] = per_edit.get(kernel, 0.0) + count * ms
        per_edit[kernel + "_graph"] = per_edit.get(kernel + "_graph", 0.0) + count * gms
        print(kernel, list(key), count, f"{ms:.4f} ms", f"graph {gms:.4f} ms",
              f"{flops / gms / 1e9:.1f} TFLOP/s", flush=True)
        del x, wt, fn

    small = min((key for (kernel, key) in calls if kernel == "conv3x3"),
                key=lambda s: s[0] * s[1] * s[2] * s[3] * s[4])
    x, wt, bias = operands(*small)
    out = torch.empty((*small[:3], small[4]), dtype=x.dtype, device="cuda")
    c_fn = library("conv3x3").conv3x3_bf16
    stream = torch.cuda.current_stream().cuda_stream
    # the plan's two ints, where the tree's C function takes them
    extra = ((k.plan_for(x, small[4]).bn, k.plan_for(x, small[4]).grid)
             if hasattr(k, "plan_for") else ())

    def c_call():
        c_fn(x.data_ptr(), wt.data_ptr(), bias.data_ptr(), out.data_ptr(), *small, 0, *extra,
             stream)

    enqueue_us, synced_us = host_us(lambda: k.conv3x3(x, wt, bias))
    c_enqueue_us, _ = host_us(c_call)

    result = dict(root=str(args.root), card=card, torch=torch.__version__,
                  ms_per_edit=per_edit, host_enqueue_us_per_conv3x3_launch=enqueue_us,
                  host_us_per_conv3x3_launch=synced_us,
                  host_enqueue_us_per_c_call=c_enqueue_us,
                  host_shape=list(small), shapes=rows)
    print(json.dumps({k_: v for k_, v in result.items() if k_ != "shapes"}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
