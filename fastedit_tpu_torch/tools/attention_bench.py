"""Time the flash attention kernels of one tree of this repository on the card.

    python fastedit_tpu_torch/tools/attention_bench.py [--root DIR] [--out FILE]

``--root`` is the checkout whose ``fastedit_tpu_torch`` is imported (default:
the one this file lies in), so two trees can be read in one run on one card,
in turns: unpack the other tree with ``git archive`` and pass its directory.
For every shape the SSD-1B edit path at 1024² (batch 1, ``tools/inventory.py``
of that tree) gives ``flash_attention`` (D = 64 and D = 512) it prints, for the
kernel and for ``F.scaled_dot_product_attention`` on the same tensors:

* ``ms``: the mean device milliseconds of 10 back-to-back eager calls (CUDA
  events), which is what ``chip_smoke.py`` reports and, where a call's device
  time is shorter than the host takes to enqueue it, a reading of the host;
* ``graph_ms``: the same from one replay of a CUDA graph that holds 20 calls,
  which leaves the host out: the device's own time per call;

then the achieved TFLOP/s of both, each kernel's sum over one edit's calls,
and the host's microseconds per ``flash_attention`` call at the smallest
D = 64 shape (the wall time of 200 calls up to the last call's return, and up
to one synchronise after it; the least of 7 such runs).  One JSON object, also
written to ``--out``.  It needs a CUDA card and ``nvcc``.
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
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("attention_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from timing import graph_ms, host_us, time_ms  # this tree's, whichever tree --root names

    sys.path.insert(0, str(Path(args.root).resolve()))
    from fastedit_tpu_torch.models import configs as C
    from fastedit_tpu_torch.ops import flash_attention as fa
    from fastedit_tpu_torch.tools import inventory

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    sites = inventory.edit_sites(C.SSD1B_UNET, C.SDXL_CONTROLNET_SMALL, C.SDXL_VAE, 1024,
                                 batch=1, steps=3)
    calls = inventory.kernel_calls(sites)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def operands(b, sq, skv, h, d):
        return tuple(torch.randn((b, s, h, d), generator=gen, device="cuda").bfloat16()
                     for s in (sq, skv, skv))

    rows, per_edit = [], {}
    for (kernel, key), count in sorted(calls.items(), key=str):
        if not kernel.startswith("flash_attention"):
            continue
        b, sq, skv, h, d = key
        q, k, v = operands(*key)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        flops = 4.0 * b * h * sq * skv * d
        kern = lambda: fa.flash_attention(q, k, v)  # noqa: E731
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)  # noqa: E731
        row = dict(kernel=kernel, shape=list(key), calls_edit=count, ms=time_ms(kern),
                   graph_ms=graph_ms(kern), sdpa_ms=time_ms(sdpa), sdpa_graph_ms=graph_ms(sdpa))
        row.update(tflops=flops / row["graph_ms"] / 1e9,
                   sdpa_tflops=flops / row["sdpa_graph_ms"] / 1e9)
        rows.append(row)
        for what in ("ms", "graph_ms", "sdpa_ms", "sdpa_graph_ms"):
            name = f"{kernel}_{what}"
            per_edit[name] = per_edit.get(name, 0.0) + count * row[what]
        print(kernel, list(key), count, {k_: round(v_, 4) for k_, v_ in row.items()
                                         if isinstance(v_, float)}, flush=True)
        del q, k, v, qt, kt, vt

    small = min((key for (kernel, key) in calls if kernel == "flash_attention_d64"),
                key=lambda s: s[0] * s[1] * s[2] * s[3])
    q, k, v = operands(*small)
    enqueue_us, synced_us = host_us(lambda: fa.flash_attention(q, k, v))

    result = dict(root=str(args.root), card=card, torch=torch.__version__, ms_per_edit=per_edit,
                  host_enqueue_us_per_launch=enqueue_us, host_us_per_launch=synced_us,
                  host_shape=list(small), shapes=rows)
    print(json.dumps({k_: v_ for k_, v_ in result.items() if k_ != "shapes"}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
