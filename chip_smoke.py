#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fastedit_tpu_torch``) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` (on PATH or under /usr/local/cuda) and
``nvidia-smi``; it imports neither JAX nor the JAX package.  Phases, in
order; a failed phase raises and the script exits non-zero:

1. Build the CUDA kernels of ``fastedit_tpu_torch/csrc/`` (one ``nvcc`` per
   source, all started together) and print the card's name and power limit.
2. Hold every kernel against its plain PyTorch version at every distinct
   shape the SSD-1B edit path at 1024² gives it, in the default kernel
   configuration and in the opt-in one (shapes and counts from the model
   configs, ``tools/inventory.py``), on seeded random bf16 inputs, and time
   the kernel, the plain version and the nearest PyTorch library call with
   CUDA events: the kernel and the library call from a CUDA graph of 20 calls
   (``ms``, ``library_ms``: the device alone) and eagerly (``eager_ms``: 10
   back-to-back calls, which read the host where a call takes the device
   less than the host takes to enqueue it), the plain version eagerly.
   Each kernel also reads a planted fault in its plain version (attention:
   the last KV tile of the kernel's plan skipped; fused conv: the padding
   ring not re-zeroed; both stride-1 convs at batch 2: the halo row above an
   image read from the neighbouring image, as a tile that straddles two
   images would; up2: one phase's tap rows swapped; down2: the other padding;
   GroupNorm and its statistics launch alone: a one-pass variance on an
   input with |mean| >> std), which the tolerance must reject; a GroupNorm
   call must run two device kernels (one on its resident route), a
   statistics call one (the profiler counts them).  The rows of the convs, attention and GroupNorm also carry
   their plan (tiles, grid, shared memory), and the host's microseconds per
   launch of the stride-1 conv, the stride-2 conv and attention are printed.
3. The main path in the default configuration:
   ``FastEditor("ssd-1b", random_weights=True)`` at 1024², a warm-up, three
   ``edit()`` calls and one ``edit_batch`` of two images, on CUDA graphs
   (``pipeline/graphs.py``).  Seconds per edit and device ms per stage (the
   editor's CUDA events around prepare and each graph replay), peak memory,
   and each kernel's launches: a replay makes no Python call, so the
   wrappers count the two keys' first calls, each an eager warm-up and a
   capture, which must come to twice the inventory's counts per key; and
   the device kernels of one replayed edit and one replayed batch of two,
   by name (``torch.profiler``), which must come to the inventory's counts
   (the phase-weight fold: none, it runs once per weight).
4. Kernels against plain versions end to end, with seeded fan-in-scaled
   weights, in two arms: the default configuration, and the opt-in one
   (``use_cuda_conv=True``: the encoder on the conv, fused resnet and
   asymmetric stride-2 kernels; ``use_cuda_groupnorm=True``: the GroupNorm
   kernel and its statistics launch, which the default turns on too).  Each
   arm: one edit on graphs (a new key: warm-up and capture, twice the
   inventory's launches), the same edit on the eager arm
   (``flags.override(cuda_graphs=False)``: the inventory's launches), which
   must give the same bits, and one with
   ``flags.override(plain_versions=True)``; final latents and images of the
   graphs against the plain edit.  Two plain edits with a planted fault
   (attention, conv) are read against the plain edit beside the limits.
5. Graphs against the eager arm, bit for bit in the final latents and the
   uint8 images, with the seeded weights: batch 1 with CFG, batch 1 without,
   an ``edit_batch`` of two; a second replay of a key on new inputs (image,
   prompt, seed, another schedule of three steps, other scales) against a
   fresh eager edit of them; a flags override, which must capture a new key.
6. A converted checkpoint, with the seeded weights of phases 4-5: the five
   models written as an HF-style fp16 snapshot (``config.json`` from the
   port's vendored public configs, diffusers / transformers names, the
   port's safetensors writer) with a small BPE vocabulary, converted by
   ``python -m fastedit_tpu_torch.tools.convert_checkpoint`` (all components
   at once, ``--expect ssd-1b`` / ``controlnet-small`` / ``vae``), loaded by
   ``FastEditor("ssd-1b", checkpoint_dir=...)``: an ``edit`` and an
   ``edit_batch`` of two on graphs, bit for bit against the in-memory editor
   after the same bf16 -> fp16 -> bf16 round trip, and the device kernels of
   one replayed edit against the inventory.  The UNet converted again with a
   seeded rank-64 kohya LoRA (with alpha) over its attention projections:
   the fused tensors against W + alpha / rank * up @ down in fp32 on the
   card (the conv tolerance; the unfused weights must fail it), and that
   checkpoint's edit against an in-memory fuse within phase 4's limits.
   Then ``MetricsCalculator(allow_random=True)`` at full width on four
   (source, edited, prompt) triples: every value finite, the batch equal to
   the per-pair calls, SSIM / PSNR / MSE of an image with itself 1 / inf / 0.
   Temporary files live under ``build/chip_smoke_checkpoint`` and are
   removed whatever happens.

Last, ``python -m fastedit_tpu_torch.bench --reps 3`` (``bench.main``) on a
new editor, whose JSON line is printed.

It prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``.  Per-shape kernel figures and the main-path timings are also
written to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_FILE = ROOT / "chiprun_out" / "chip_smoke.json"

# Published H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core rate
# and HBM3 bandwidth.  A bound is the larger of operations / peak rate and
# bytes / bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

RESOLUTION = 1024
EDIT_KW = dict(strength=0.8, num_inference_steps=4, guidance_scale=1.5)
# The opt-in kernel configuration of phase 4 (the path of the encoder's
# fused and stride-2 kernels; the GroupNorm kernel, on by default, stays on).
OPT_IN = dict(use_cuda_conv=True, use_cuda_groupnorm=True)

# Kernel vs plain version, per element, in bf16.  Both accumulate in fp32
# and round once to bf16, so they differ by the final rounding (one bf16
# ulp, at most 2^-7 of the value) plus fp32 summation-order differences,
# which matter only for outputs near zero: the absolute term.  It holds for
# every conv form and for the GroupNorm kernel.
CONV_REL, CONV_ABS_OF_MAX = 2.0**-7, 2.0**-10
# Attention: the same relative term; the absolute term scales with the
# RMS of the output, which shrinks as 1/sqrt(Skv) for a flat softmax.  It
# lies between the worst reading of the kernel and that of a planted fault
# (the plain version with the kernel's last KV tile skipped), both read on
# the card in every run (phase 2).
ATTN_REL, ATTN_ABS_OF_RMS = 2.0**-7, 2.0**-3
# GroupNorm's |mean| >> std input: bf16 values 384 and 386 (one in 512 is
# 386): std ~0.09, far below what fp32 resolves of E[x^2] ~ 147456 (ulp
# 2^-6), so a one-pass variance is noise while the two-pass one is exact.
GN_OFFSET, GN_SPIKE, GN_SPIKE_RATE = 384.0, 2.0, 1.0 / 512
# End to end (phase 4): the paths agree per op within the bounds above, and
# bf16 rounding differences (2^-9 relative) at some 200 sequential layers
# per step over 3 steps leave a few percent at most in the final latents.
# Planted faults are read in the same run, against the plain edit: a conv
# kernel that skips its last Cin step must fail these limits.  A skipped
# attention KV tile moves the latents no more than bf16 rounding does, so
# it is recorded only; phase 2 catches it.
E2E_LATENT_REL_L2 = 5e-2
E2E_IMAGE_MEAN_LSB = 4.0


def log(*args) -> None:
    print(*args, flush=True)


def count_hgmma(library_path: Path) -> dict:
    """Warpgroup MMA instructions (SASS ``HGMMA``, what ``wgmma.mma_async``
    compiles to) per kernel of a built library, from ``cuobjdump -sass``;
    empty where the toolkit has no ``cuobjdump``."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(library_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name is not None and "HGMMA" in line:
            counts[name] += 1
    return counts


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def n_outside(out, ref, rel: float, abs_tol: float) -> int:
    """Elements with |out - ref| > rel * |ref| + abs_tol, or not finite."""
    d = (out.float() - ref.float()).abs()
    return int((~(d <= rel * ref.float().abs() + abs_tol)).sum())


def check_close(what: str, out, ref, rel: float, abs_tol: float) -> tuple[float, float]:
    """Raise unless |out - ref| <= rel * |ref| + abs_tol everywhere; return
    (max abs error, max abs error / max |ref|)."""
    d = (out.float() - ref.float()).abs()
    n_bad = n_outside(out, ref, rel, abs_tol)
    err, scale = float(d.max()), float(ref.float().abs().max())
    if n_bad or not bool(out.float().isfinite().all()):
        raise AssertionError(
            f"{what}: {n_bad} elements outside tolerance (max abs err {err}, "
            f"max |ref| {scale})"
        )
    return err, err / max(scale, 1e-30)


def conv_tol(ref) -> float:
    return CONV_ABS_OF_MAX * float(ref.float().abs().max())


def err_over_rms(out, ref, rel: float) -> float:
    """The least c for which |out - ref| <= rel * |ref| + c * rms(ref)
    holds everywhere."""
    d = (out.float() - ref.float()).abs() - rel * ref.float().abs()
    return float(d.max().clamp(min=0.0)) / float(ref.float().square().mean().sqrt())


# ------------------------------------------------------------------ phase 2


def kernel_shapes():
    """Kernel calls per edit of the SSD-1B edit path at 1024², keyed by
    (kernel, shape): the default configuration for one ``edit`` and one
    ``edit_batch`` of two, and the opt-in configuration for one ``edit``."""
    from fastedit_tpu_torch.models import configs as C
    from fastedit_tpu_torch.ops import flags
    from fastedit_tpu_torch.tools import inventory

    args = (C.SSD1B_UNET, C.SDXL_CONTROLNET_SMALL, C.SDXL_VAE, RESOLUTION)
    sites = {b: inventory.edit_sites(*args, batch=b, steps=3) for b in (1, 2)}
    calls = {f"default_b{b}": inventory.kernel_calls(sites[b]) for b in (1, 2)}
    with flags.override(**OPT_IN):
        calls["optin_b1"] = inventory.kernel_calls(sites[1])
    return calls


def keys_of(calls: dict, kernel: str) -> list:
    return sorted({key for c in calls.values() for (k, key) in c if k == kernel}, key=str)


def _parts(t) -> tuple:
    return tuple(t) if isinstance(t, (tuple, list)) else (t,)


def hold_close(what: str, out, ref) -> tuple[float, float]:
    """``check_close`` with the conv tolerance, part by part where the
    outputs are tuples (the GroupNorm statistics' scale and shift, each held
    to its own scale)."""
    errs = [check_close(what, o, r, CONV_REL, conv_tol(r))
            for o, r in zip(_parts(out), _parts(ref), strict=True)]
    return max(e for e, _ in errs), max(r for _, r in errs)


def outside(out, ref) -> int:
    return sum(n_outside(o, r, CONV_REL, conv_tol(r))
               for o, r in zip(_parts(out), _parts(ref), strict=True))


def hold(calls, kernel, key, kern, plain, library, flops, nbytes, faults=None,
         extra=None) -> dict:
    """Check ``kern()`` against ``plain()`` with the conv tolerance (and every
    planted fault of ``faults``, by name, against it, which must fail), then
    time the kernel, the plain version and the library call (``None`` where
    no one PyTorch call computes the same function).  One row of the
    per-shape table."""
    import torch

    from fastedit_tpu_torch.tools.timing import graph_ms, time_ms

    out, ref = kern(), plain()
    torch.cuda.synchronize()
    err, rel = hold_close(f"{kernel} {key}", out, ref)
    row = dict(kernel=kernel, shape=list(key), max_abs_err=err, max_rel_err=rel)
    for name, make in (faults or {}).items():
        bad = outside(make(), ref)
        row[f"{name}_elements_outside"] = bad
        if bad == 0:
            raise AssertionError(f"{kernel} {key}: the tolerance passes the planted {name}")
    del out, ref
    b_ms, b_by = bound_ms(flops, nbytes)
    row.update(extra or {})
    row.update(
        calls_edit=calls["default_b1"].get((kernel, key), 0),
        calls_edit_batch2=calls["default_b2"].get((kernel, key), 0),
        calls_edit_optin=calls["optin_b1"].get((kernel, key), 0),
        ms=graph_ms(kern), library_ms=graph_ms(library) if library else None,
        plain_ms=time_ms(plain), eager_ms=time_ms(kern),
        library_eager_ms=time_ms(library) if library else None,
        bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
    )
    row["tflops"] = flops / row["ms"] / 1e9
    log(kernel, list(key), {k: row[k] for k in (
        "max_abs_err", "max_rel_err", "ms", "library_ms", "plain_ms", "eager_ms",
        "library_eager_ms", "bound_ms", "tflops")},
        {k: v for k, v in row.items() if k.endswith("_elements_outside")},
        {k: row[k] for k in ("plan", "prologue_exps") if k in row})
    return row


def _conv_operands(gen, n, h, w, cin, cout):
    import torch

    x = torch.randn((n, h, w, cin), generator=gen, device="cuda").bfloat16()
    wt = torch.randn((cout, cin, 3, 3), generator=gen, device="cuda") * (9 * cin) ** -0.5
    wt = wt.bfloat16().contiguous(memory_format=torch.channels_last)
    bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
    return x, wt, bias


def plan_of(x, cout: int, down2_asymmetric=None, up2: bool = False) -> dict:
    """The conv kernel's schedule for this call (stride 1, the upsample form,
    or stride 2 where ``down2_asymmetric`` says which padding), as a row
    records it."""
    from fastedit_tpu_torch.ops.conv3x3 import plan_down2_for, plan_for, plan_up2_for

    if up2:
        pl = plan_up2_for(x, cout)
    else:
        pl = (plan_for(x, cout) if down2_asymmetric is None
              else plan_down2_for(x, cout, down2_asymmetric))
    return dict(rect=list(pl.rect), bn=pl.bn, tiles=pl.tiles, grid=pl.grid,
                smem_bytes=pl.smem_bytes)


def neighbour_halo(xin, wt):
    """The fp32 conv of NHWC ``xin`` whose padding row above each image holds
    the last row of the image before it in the batch instead of zeros: what a
    tile that straddles two images computes along an image's top edge."""
    import torch.nn.functional as F

    xp = F.pad(xin.float(), (0, 0, 1, 1, 1, 1))
    xp[:, 0, 1:-1] = xin.float().roll(1, dims=0)[:, -1]
    return F.conv2d(xp.permute(0, 3, 1, 2), wt.float()).permute(0, 2, 3, 1)


def compare_conv(calls: dict, gen) -> list[dict]:
    """Fault, at batch 2: the halo row above an image taken from the
    neighbouring image.  Library: ``F.conv2d`` in bf16."""
    import torch.nn.functional as F

    from fastedit_tpu_torch.ops import conv3x3 as k

    rows = []
    for key in keys_of(calls, "conv3x3"):
        n, h, w, cin, cout = key
        x, wt, bias = _conv_operands(gen, n, h, w, cin, cout)
        x_nchw, bias_bf = x.permute(0, 3, 1, 2), bias.bfloat16()
        faults = {}
        if n > 1:
            faults["neighbour_halo"] = lambda: (neighbour_halo(x, wt) + bias).bfloat16()
        rows.append(hold(
            calls, "conv3x3", key,
            lambda: k.conv3x3(x, wt, bias), lambda: k.conv3x3_plain(x, wt, bias),
            lambda: F.conv2d(x_nchw, wt, bias_bf, padding=1),
            flops=2.0 * n * h * w * cout * 9 * cin,
            nbytes=2.0 * (n * h * w * cin + 9 * cin * cout + n * h * w * cout) + 4.0 * cout,
            faults=faults, extra=dict(plan=plan_of(x, cout)),
        ))
    return rows


def host_us_per_launch(calls: dict, gen, launches: int = 200, trials: int = 5) -> list[dict]:
    """Host microseconds per call of ``conv3x3``, ``conv3x3_down2`` and
    ``flash_attention`` (D = 64), each at the main path's smallest shape
    (``tools/timing.host_us``: to enqueue, and with one synchronise at the
    end; the least of ``trials`` runs of ``launches`` calls)."""
    import math

    import torch

    from fastedit_tpu_torch.ops import conv3x3 as k
    from fastedit_tpu_torch.ops import conv_fused as cf
    from fastedit_tpu_torch.ops import flash_attention as fa
    from fastedit_tpu_torch.tools.timing import host_us

    def smallest(kernel):
        return min(keys_of(calls, kernel), key=lambda s: math.prod(int(v) or 1 for v in s))

    conv_key, down_key, attn_key = (smallest(n) for n in (
        "conv3x3", "conv3x3_down2", "flash_attention_d64"))
    x, wt, bias = _conv_operands(gen, *conv_key)
    xd, wd, bd = _conv_operands(gen, *down_key[:5])
    b, sq, skv, h, d = attn_key
    q, kk, v = (torch.randn((b, s_, h, d), generator=gen, device="cuda").bfloat16()
                for s_ in (sq, skv, skv))
    rows = []
    for name, key, fn in (
            ("conv3x3", conv_key, lambda: k.conv3x3(x, wt, bias)),
            ("conv3x3_down2", down_key,
             lambda: cf.conv3x3_down2(xd, wd, bd, asymmetric=down_key[5])),
            ("flash_attention_d64", attn_key, lambda: fa.flash_attention(q, kk, v))):
        enqueue_us, us = host_us(fn, launches, trials)
        log(f"host us per {name} launch at {list(key)}: {enqueue_us:.2f} to enqueue, {us:.2f} "
            "with one synchronise at the end")
        rows.append(dict(kernel=name, shape=list(key), launches=launches, trials=trials,
                         host_enqueue_us_per_launch=enqueue_us, host_us_per_launch=us))
    return rows


def compare_fused(calls: dict, gen) -> list[dict]:
    """The fused resnet conv with its prologue, per-batch or shared bias
    and skip as the key says.  Fault: the prologue applied to the padded
    input, so the ring holds silu(shift) instead of zero.  Library: the
    bare conv (``F.conv2d``), without the prologue and epilogue."""
    import torch
    import torch.nn.functional as F

    from fastedit_tpu_torch.ops import conv_fused as cf

    from fastedit_tpu_torch.ops.conv3x3 import plan_for

    rows = []
    for key in keys_of(calls, "conv3x3_fused"):
        n, h, w, cin, cout, per_batch_bias, has_skip = key
        x, wt, bias = _conv_operands(gen, n, h, w, cin, cout)
        if per_batch_bias:
            bias = torch.randn((n, cout), generator=gen, device="cuda") * 0.1
        scale = torch.rand((n, cin), generator=gen, device="cuda") + 0.5
        shift = torch.randn((n, cin), generator=gen, device="cuda") * 0.5
        skip = (torch.randn((n, h, w, cout), generator=gen, device="cuda").bfloat16()
                if has_skip else None)
        pre = (scale, shift)

        def finish(out):
            out = out + (bias[:, None, None, :] if bias.dim() == 2 else bias)
            return (out if skip is None else out + skip.float()).bfloat16()

        def ring_not_zeroed():
            xp = F.pad(x, (0, 0, 1, 1, 1, 1))  # NHWC, zero ring
            xr = cf.prologue_plain(xp, scale, shift)
            return finish(F.conv2d(xr.permute(0, 3, 1, 2).float(),
                                   wt.float()).permute(0, 2, 3, 1))

        faults = {"fault": ring_not_zeroed}
        if n > 1:
            faults["neighbour_halo"] = lambda: finish(
                neighbour_halo(cf.prologue_plain(x, scale, shift), wt))

        x_nchw, bias_bf = x.permute(0, 3, 1, 2), bias.reshape(-1, cout)[0].bfloat16()
        nbytes = (2.0 * (n * h * w * cin + 9 * cin * cout + n * h * w * cout * (2 if skip is not None else 1))
                  + 4.0 * (bias.numel() + 2 * n * cin))
        rows.append(hold(
            calls, "conv3x3_fused", key,
            lambda: cf.conv3x3_fused(x, wt, bias, pre, skip=skip),
            lambda: cf.conv3x3_fused_plain(x, wt, bias, pre, skip=skip),
            lambda: F.conv2d(x_nchw, wt, bias_bf, padding=1),
            flops=2.0 * n * h * w * cout * 9 * cin, nbytes=nbytes,
            faults=faults, extra=dict(
                plan=plan_of(x, cout),
                prologue_exps=plan_for(x, cout).prologue_exps(n, h, w, cin)),
        ))
    return rows


def compare_up2(calls: dict, gen) -> list[dict]:
    """Fault: phase (1, 1) with its two tap rows swapped.  Library: the
    materialised upsample and the conv, two calls (``repeat_interleave``
    + ``F.conv2d``).  The kernel takes its phase weights folded once
    (``fold_up2``), as on the main path."""
    import torch.nn.functional as F

    from fastedit_tpu_torch.ops import conv_fused as cf

    rows = []
    for key in keys_of(calls, "conv3x3_up2"):
        n, h, w, cin, cout = key
        x, wt, bias = _conv_operands(gen, n, h, w, cin, cout)
        phases = cf.make_phase_kernels(wt)
        swapped = phases.clone()
        swapped[1, 1] = phases[1, 1].flip(0)
        folded = cf.fold_up2(wt)  # once, as the upsampler modules fold them
        x_nchw, bias_bf = x.permute(0, 3, 1, 2), bias.bfloat16()

        def library():
            up = x_nchw.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            return F.conv2d(up, wt, bias_bf, padding=1)

        rows.append(hold(
            calls, "conv3x3_up2", key,
            lambda: cf.conv3x3_up2(x, wt, bias, phases=folded),
            lambda: cf.conv3x3_up2_plain(x, wt, bias),
            library, flops=32.0 * n * h * w * cin * cout,
            nbytes=2.0 * (n * h * w * cin + 9 * cin * cout + 4 * n * h * w * cout) + 4.0 * cout,
            faults={"fault": lambda: cf.up2_phases_plain(x, swapped, bias)},
            extra=dict(plan=plan_of(x, cout, up2=True)),
        ))
    return rows


def compare_down2(calls: dict, gen) -> list[dict]:
    """Fault: the other padding ((1, 1) where (0, 1) is asked, and the
    reverse).  Library: ``F.conv2d(stride=2)`` (after ``F.pad`` for the
    asymmetric padding)."""
    import torch.nn.functional as F

    from fastedit_tpu_torch.ops import conv_fused as cf

    rows = []
    for key in keys_of(calls, "conv3x3_down2"):
        n, h, w, cin, cout, asym = key
        x, wt, bias = _conv_operands(gen, n, h, w, cin, cout)
        x_nchw, bias_bf = x.permute(0, 3, 1, 2), bias.bfloat16()

        def library():
            if asym:
                return F.conv2d(F.pad(x_nchw, (0, 1, 0, 1)), wt, bias_bf, stride=2)
            return F.conv2d(x_nchw, wt, bias_bf, stride=2, padding=1)

        ho, wo = h // 2, w // 2
        rows.append(hold(
            calls, "conv3x3_down2", key,
            lambda: cf.conv3x3_down2(x, wt, bias, asymmetric=asym),
            lambda: cf.conv3x3_down2_plain(x, wt, bias, asymmetric=asym),
            library, flops=2.0 * n * ho * wo * cout * 9 * cin,
            nbytes=2.0 * (n * h * w * cin + 9 * cin * cout + n * ho * wo * cout) + 4.0 * cout,
            faults={"fault": lambda: cf.conv3x3_down2_plain(x, wt, bias, asymmetric=not asym)},
            extra=dict(plan=plan_of(x, cout, down2_asymmetric=asym)),
        ))
    return rows


def device_kernels(fn, calls: int = 3, tries: int = 5) -> list[str]:
    """The names of the device kernels one call of ``fn`` runs, by
    ``torch.profiler`` (CUDA activity) over ``calls`` calls, which must run
    the same number each.  A trace now and then loses its first records (a
    few kernels, or in one run every kernel of the first ones), so a spin of
    ~50 ms and then eight short marker spins (``torch.cuda._sleep``) run
    first and only the kernels after the last marker are read; a profile
    that still lost records (no marker, nothing after it, or a count that is
    no multiple of ``calls``) is taken again, up to ``tries`` in all, and
    raises when every try lost them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(100_000_000)
            for _ in range(8):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        names = [e.name for e in events]
        marks = [i for i, name in enumerate(names) if "spin_kernel" in name]
        after = names[marks[-1] + 1:] if marks else []
        seen.append((len(names), len(marks), len(after)))
        if after and len(after) % calls == 0:
            return after[:len(after) // calls]
    raise AssertionError(f"the profiler lost records in all {tries} tries of {calls} calls "
                         f"(device kernels, markers, kernels after the last marker: {seen})")


def compare_group_norm(calls: dict, gen) -> list[dict]:
    """The GroupNorm kernel (``group_norm``) and its statistics launch alone
    (``group_norm_scale_shift``, the fused resnet conv's (scale, shift)).
    Two inputs per shape: normal values, held and timed; and the |mean| >>
    std input, held too, with the planted fault (a one-pass variance) read on
    it.  Each call must run one or two device kernels (the profiler counts
    them): two for GroupNorm (one on the resident route), one for the
    statistics.  Library: ``F.group_norm`` (+ ``F.silu``) on channels_last
    NCHW for GroupNorm; for the statistics ``torch.var_mean`` over each
    group's pixels and channels, the reduction that dominates them (the
    fold with the affine into scale and shift is a few hundred elements)."""
    import torch
    import torch.nn.functional as F

    from fastedit_tpu_torch.ops import fused_groupnorm as fg
    from fastedit_tpu_torch.ops.groupnorm import group_norm_plain, group_norm_scale_shift_plain

    def one_pass_stats(x, groups):
        b, h, w, c = x.shape
        xf = x.float().reshape(b, h * w, groups, c // groups)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = xf.square().mean(dim=(1, 3), keepdim=True) - mean.square()
        return xf, mean, var

    def one_pass(x, gamma, beta, groups, act):
        xf, mean, var = one_pass_stats(x, groups)
        out = ((xf - mean) * torch.rsqrt(var + 1e-5)).reshape(x.shape) * gamma + beta
        return (F.silu(out) if act == "silu" else out).bfloat16()

    def one_pass_scale_shift(x, gamma, beta, groups):
        _, mean, var = one_pass_stats(x, groups)
        cg = x.shape[-1] // groups
        scale = torch.rsqrt(var + 1e-5)[:, 0, :, 0].repeat_interleave(cg, dim=1) * gamma
        return scale, beta - mean[:, 0, :, 0].repeat_interleave(cg, dim=1) * scale

    rows = []
    for kernel, launches in (("group_norm", 2), ("group_norm_scale_shift", 1)):
        for key in keys_of(calls, kernel):
            n, h, w, c, groups = key[:5]
            act = key[5] if kernel == "group_norm" else None
            if kernel == "group_norm":
                def kern(x):
                    return fg.fused_group_norm(x, gamma, beta, groups, 1e-5, act)

                def plain(x):
                    return group_norm_plain(x, gamma, beta, groups, 1e-5, act)

                def fault(x):
                    return one_pass(x, gamma, beta, groups, act)
            else:
                def kern(x):
                    return fg.group_norm_scale_shift(x, gamma, beta, groups, 1e-5)

                def plain(x):
                    return group_norm_scale_shift_plain(x, gamma, beta, groups, 1e-5)

                def fault(x):
                    return one_pass_scale_shift(x, gamma, beta, groups)
            gamma = torch.randn(c, generator=gen, device="cuda") * 0.5 + 1.0
            beta = torch.randn(c, generator=gen, device="cuda") * 0.2
            spikes = torch.rand((n, h, w, c), generator=gen, device="cuda") < GN_SPIKE_RATE
            offset = (GN_OFFSET + GN_SPIKE * spikes.float()).bfloat16()
            del spikes
            out, ref = kern(offset), plain(offset)
            torch.cuda.synchronize()
            off_err, _ = hold_close(f"{kernel} {key}, |mean| >> std", out, ref)
            fault_bad = outside(fault(offset), ref)
            del out, ref
            if fault_bad == 0:
                raise AssertionError(f"{kernel} {key}: the tolerance passes a one-pass variance")
            names = device_kernels(lambda: kern(offset))
            del offset
            if not 1 <= len(names) <= launches:
                raise AssertionError(f"{kernel} {key}: {len(names)} device kernels per call "
                                     f"({names}), expected 1 to {launches}")

            x = (torch.randn((n, h, w, c), generator=gen, device="cuda") * 2.0 + 0.5).bfloat16()
            x_nchw = x.permute(0, 3, 1, 2)
            g_bf, b_bf = gamma.bfloat16(), beta.bfloat16()

            x_groups = x.view(n, h * w, groups, c // groups)

            def library():
                if kernel == "group_norm_scale_shift":
                    return torch.var_mean(x_groups, dim=(1, 3), correction=0)
                y = F.group_norm(x_nchw, groups, g_bf, b_bf, 1e-5)
                return F.silu(y) if act == "silu" else y

            elems = n * h * w * c
            rows.append(hold(
                calls, kernel, key, lambda: kern(x), lambda: plain(x), library,
                flops=(8.0 if kernel == "group_norm" else 4.0) * elems,
                # x read once, and the output written once (bf16) or (scale, shift) (fp32)
                nbytes=2.0 * elems + 8.0 * c + (2.0 * elems if kernel == "group_norm"
                                                else 8.0 * n * c),
                extra=dict(offset_max_abs_err=off_err, fault_elements_outside=fault_bad,
                           device_kernels_per_call=len(names), device_kernel_names=names,
                           plan=gn_plan_of(x, groups)),
            ))
            del x, x_nchw, x_groups
    return rows


def gn_plan_of(x, groups: int) -> dict:
    """The GroupNorm kernels' schedule for this call, as a row records it."""
    from fastedit_tpu_torch.ops.fused_groupnorm import plan_for

    pl = plan_for(x, groups)
    return dict(lanes=pl.lanes, threads=pl.threads, tile_px=pl.tile_px, stages=pl.stages,
                grid=list(pl.grid), apply_grid=list(pl.apply_grid), smem_bytes=pl.smem_bytes,
                route=pl.route)


def compare_attention(calls: dict, gen) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from fastedit_tpu_torch.ops import flash_attention as fa
    from fastedit_tpu_torch.tools.timing import graph_ms, time_ms

    rows, weak = [], []
    keys = sorted({key for c in calls.values() for (k, key) in c
                   if k.startswith("flash_attention")})
    for key in keys:
        b, sq, skv, h, d = key
        name = f"flash_attention_d{d}"
        q = torch.randn((b, sq, h, d), generator=gen, device="cuda").bfloat16()
        kk = torch.randn((b, skv, h, d), generator=gen, device="cuda").bfloat16()
        v = torch.randn((b, skv, h, d), generator=gen, device="cuda").bfloat16()
        out = fa.flash_attention(q, kk, v)
        ref = fa.attention_plain(q, kk, v)
        pl = fa.plan_for(q, skv)
        tile = pl.bkv  # one KV tile of the kernel that runs
        faulty = fa.attention_plain(q, kk[:, :-tile], v[:, :-tile])
        torch.cuda.synchronize()
        sound_c, fault_c = err_over_rms(out, ref, ATTN_REL), err_over_rms(faulty, ref, ATTN_REL)
        log("attention", list(key), f"err/rms kernel {sound_c:.5f}, "
            f"last KV tile skipped {fault_c:.5f}, limit {ATTN_ABS_OF_RMS}")
        if fault_c <= ATTN_ABS_OF_RMS:
            weak.append(f"flash_attention {key}: the tolerance passes "
                        f"a skipped KV tile ({fault_c} <= {ATTN_ABS_OF_RMS})")
        err, rel = check_close(
            f"flash_attention {key}", out, ref, ATTN_REL,
            ATTN_ABS_OF_RMS * float(ref.float().square().mean().sqrt()),
        )
        del ref, out, faulty
        qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, v))
        flops = 4.0 * b * h * sq * skv * d
        nbytes = 2.0 * b * h * d * (2 * sq + 2 * skv)
        b_ms, b_by = bound_ms(flops, nbytes)
        rows.append(dict(
            kernel=name, shape=list(key),
            calls_edit=calls["default_b1"].get((name, key), 0),
            calls_edit_batch2=calls["default_b2"].get((name, key), 0),
            calls_edit_optin=calls["optin_b1"].get((name, key), 0),
            max_abs_err=err, max_rel_err=rel, err_over_rms=sound_c,
            fault_err_over_rms=fault_c,
            ms=graph_ms(lambda: fa.flash_attention(q, kk, v)),
            library_ms=graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            plain_ms=time_ms(lambda: fa.attention_plain(q, kk, v)),
            eager_ms=time_ms(lambda: fa.flash_attention(q, kk, v)),
            library_eager_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
            plan=dict(bq=pl.bq, bkv=pl.bkv, stages=pl.stages, v_stages=pl.v_stages,
                      tiles=pl.tiles, grid=pl.grid, smem_bytes=pl.smem_bytes),
        ))
        rows[-1]["tflops"] = flops / rows[-1]["ms"] / 1e9
        log("attention", rows[-1]["shape"], {k: rows[-1][k] for k in
            ("max_abs_err", "max_rel_err", "ms", "library_ms", "plain_ms", "eager_ms",
             "library_eager_ms", "bound_ms", "tflops", "plan")})
    if weak:
        raise AssertionError("\n".join(weak))
    return rows


# ------------------------------------------------------------------ phase 3


def test_image(seed: int, n: int = RESOLUTION):
    """A seeded RGB scene with gradients, blocks and noise (Canny finds
    edges in it at the default thresholds)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:n, :n]
    img = np.stack([xx * 255 // n, yy * 255 // n, (xx + yy) * 255 // (2 * n)], -1)
    img = img + rng.integers(-12, 13, img.shape)
    for _ in range(16):
        y0, x0 = rng.integers(0, n - n // 8, 2)
        dy, dx = rng.integers(n // 32, n // 8, 2)
        img[y0:y0 + dy, x0:x0 + dx] = rng.integers(0, 256, 3)
    return Image.fromarray(np.clip(img, 0, 255).astype(np.uint8), "RGB")


def check_launches(what: str, launches: dict, expected: dict) -> None:
    """Every kernel's launches equal the inventory's, and every kernel the
    inventory expects was launched."""
    log(f"launches ({what}):", launches, "expected:", expected)
    for name, n in expected.items():
        if launches.get(name) != n:
            raise AssertionError(f"{what}: {name} launched {launches.get(name)} times, "
                                 f"expected {n}")


# A launch of each wrapper runs these device kernels (a part of their
# demangled names): GroupNorm's two-launch route gn_stats_kernel<false> and
# gn_apply_kernel, its resident route gn_stats_kernel<true> alone, the
# statistics entry gn_stats_kernel<false> alone.
WRAPPER_KERNELS = {
    "conv3x3": "conv3x3_kernel", "conv3x3_fused": "conv3x3_fused_kernel",
    "conv3x3_up2": "conv3x3_up2_kernel", "conv3x3_down2": "conv3x3_down2_kernel",
    "flash_attention_d64": "flash_d64_kernel", "flash_attention_d512": "flash_d512_kernel",
    "up2_phase_weights": "up2_phase_weights_kernel",
}


def wrapper_launches(names: list) -> dict:
    """Wrapper -> its launches among the device kernels ``names``."""
    def count(part):
        return sum(part in name for name in names)

    out = {wrapper: count(part) for wrapper, part in WRAPPER_KERNELS.items()}
    apply = count("gn_apply_kernel")
    out["group_norm"] = apply + count("gn_stats_kernel<true>")
    out["group_norm_scale_shift"] = count("gn_stats_kernel<false>") - apply
    return out


def check_image(img) -> None:
    import numpy as np

    arr = np.asarray(img)
    if arr.dtype != np.uint8 or arr.shape != (RESOLUTION, RESOLUTION, 3):
        raise AssertionError(f"edit returned {arr.dtype} {arr.shape}")


def main_path(calls: dict):
    import torch

    from fastedit_tpu_torch import FastEditor
    from fastedit_tpu_torch.pipeline.graphs import STAGES
    from fastedit_tpu_torch.tools.inventory import (
        launch_counts, launches_by_kernel, reset_launch_counts)

    t0 = time.perf_counter()
    editor = FastEditor("ssd-1b", random_weights=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    images = [test_image(1), test_image(2)]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    warm_s = editor.warmup(**EDIT_KW)
    log(f"editor built in {build_s:.2f} s, warm-up edit (eager run and capture) {warm_s:.2f} s")
    edits = []
    for i in range(3):
        t = time.perf_counter()
        out = editor.edit(images[0], "a watercolor painting of a harbor", seed=i, **EDIT_KW)
        edits.append(dict(seconds=time.perf_counter() - t, stage_ms=editor.stage_ms()))
        check_image(out)
        log(f"edit {i}: {edits[-1]['seconds']:.4f} s", edits[-1]["stage_ms"])
    t = time.perf_counter()
    outs = editor.edit_batch(images, ["a snowy street", "a city at night"], seed=3, **EDIT_KW)
    batch = dict(seconds=time.perf_counter() - t, stage_ms=editor.stage_ms())
    for out in outs:
        check_image(out)
    log(f"edit_batch of 2 (its first call: eager run and capture): {batch['seconds']:.4f} s",
        batch["stage_ms"])
    t = time.perf_counter()
    outs = editor.edit_batch(images, ["a snowy street", "a city at night"], seed=4, **EDIT_KW)
    batch_replay = dict(seconds=time.perf_counter() - t, stage_ms=editor.stage_ms())
    log(f"edit_batch of 2, replayed: {batch_replay['seconds']:.4f} s", batch_replay["stage_ms"])
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 1024**3
    keys = editor._graphs.captured
    if len(keys) != 2 or any(tuple(c.graphs) != STAGES for c in keys.values()):
        raise AssertionError(f"expected two keys of three graphs each, got {list(keys)}")

    per_edit = launches_by_kernel(calls["default_b1"])
    per_batch2 = launches_by_kernel(calls["default_b2"])
    expected = {k: 2 * (per_edit[k] + per_batch2[k]) for k in per_edit}
    check_launches("two keys' first calls (eager warm-up and capture each), then replays",
                   launches, expected)
    pools = {str(k[:5]): c.pool_bytes / 1024**3 for k, c in keys.items()}
    log(f"peak device memory {peak_gib:.3f} GiB; graph pool GiB by key {pools}")
    replays = {}
    for what, edit, expected in (
            ("edit", lambda: editor.edit(images[0], "a watercolor painting of a harbor",
                                         seed=5, **EDIT_KW), per_edit),
            ("edit_batch of 2", lambda: editor.edit_batch(
                images, ["a snowy street", "a city at night"], seed=6, **EDIT_KW), per_batch2)):
        # two replays per profile: a profile that lost a record is taken again
        replays[what] = wrapper_launches(device_kernels(edit, calls=2))
        check_launches(f"one replayed {what}, device kernels by the profiler",
                       replays[what], {**expected, "up2_phase_weights": 0})
    if len(keys) != 2:
        raise AssertionError(f"the profiled replays captured another key: {list(keys)}")
    return editor, dict(
        editor_build_s=build_s, warmup_s=warm_s, edits=edits, edit_batch2=batch,
        edit_batch2_replay=batch_replay, launches=launches, launches_per_edit=per_edit,
        replay_launches=replays, peak_gib=peak_gib, graph_pool_gib=pools,
    )


# ------------------------------------------------------------------ phase 4


def seeded_weights_(editor, seed: int) -> None:
    """Seeded fan-in-scaled normal weights on the card, zero biases,
    identity norms, as the tiny model is initialised (the zero weights of
    ``random_weights`` prove nothing about values)."""
    import torch

    from fastedit_tpu_torch.pipeline.editor import _seeded_init_

    gen = torch.Generator(device="cuda").manual_seed(seed)
    mod = editor.modules
    for model in (mod.unet, mod.controlnet, mod.vae, mod.text_encoder, mod.text_encoder_2):
        _seeded_init_(model, gen)
    editor.clear_memory()  # cached prompt embeddings came from the old weights


@contextlib.contextmanager
def planted_fault(kind: str):
    """Plant a kernel-sized fault in the plain versions, inside the kernel's
    gate: ``attention`` skips the last KV tile of the kernel's plan, as a
    kernel whose loop stops one tile short; ``conv`` skips the last Cin step (64 channels) of the
    last tap, as a kernel whose K loop stops one step short."""
    from fastedit_tpu_torch.ops import conv3x3, flash_attention

    if kind == "attention":
        # the module, not the function that ``ops/__init__.py`` exports
        module, name = sys.modules["fastedit_tpu_torch.ops.attention"], "attention_plain"
        orig = module.attention_plain

        def faulty(q, k, v, scale=None):
            if flash_attention.supports(tuple(q.shape), k.shape[1]):
                b, sq, h, d = q.shape
                tile = flash_attention.plan(b, sq, k.shape[1], h, d).bkv
                k, v = k[:, :-tile], v[:, :-tile]
            return orig(q, k, v, scale)
    else:
        module, name = conv3x3, "conv3x3_plain"
        orig = conv3x3.conv3x3_plain

        def faulty(x, weight, bias=None, act=None):
            w = weight.clone()
            w[:, (w.shape[1] - 1) // 64 * 64:, 2, 2] = 0
            return orig(x, w, bias, act)
    setattr(module, name, faulty)
    try:
        yield
    finally:
        setattr(module, name, orig)


def differ(a, b) -> dict:
    """(uint8 images, final latents) pairs: their distance."""
    import numpy as np

    diff = np.abs(a[0].astype(np.int32) - b[0].astype(np.int32))
    return dict(latent_rel_l2=float((a[1].float() - b[1].float()).norm() / b[1].float().norm()),
                image_mean_abs_lsb=float(diff.mean()), image_max_abs_lsb=int(diff.max()))


def same_bits(what: str, a, b) -> None:
    """Graphs against the eager arm: the same uint8 images and final latents."""
    import numpy as np

    if not (np.array_equal(a[0], b[0]) and bool((a[1] == b[1]).all())):
        raise AssertionError(f"{what}: graphs and the eager arm differ: {differ(a, b)}")


def edit_arrays(editor, images, prompts, **kw):
    """One ``edit_batch``: (uint8 images [B, r, r, 3], final latents, host
    seconds, device ms per stage)."""
    import numpy as np

    t = time.perf_counter()
    outs = editor.edit_batch(images, prompts, **kw)
    sec = time.perf_counter() - t
    lat = editor.last_latents.clone()
    if not bool(lat.isfinite().all()):
        raise AssertionError("non-finite final latents")
    return np.stack([np.asarray(o) for o in outs]), lat, sec, editor.stage_ms()


def kernels_vs_plain(editor, calls: dict) -> dict:
    import torch

    from fastedit_tpu_torch.ops import flags
    from fastedit_tpu_torch.tools.inventory import (
        launch_counts, launches_by_kernel, reset_launch_counts)

    seeded_weights_(editor, seed=20261016)  # drops the graphs: the weights changed
    img, prompt = test_image(5), "an oil painting of a lighthouse"
    editor._encode_prompts([prompt, ""])

    def run(fault=None, **override):
        with flags.override(**override), (planted_fault(fault) if fault
                                          else contextlib.nullcontext()):
            return edit_arrays(editor, [img], [prompt], seed=11, **EDIT_KW)

    def within_limits(what, res):
        if (res["latent_rel_l2"] > E2E_LATENT_REL_L2
                or res["image_mean_abs_lsb"] > E2E_IMAGE_MEAN_LSB):
            raise AssertionError(
                f"{what}: kernel edit differs from plain edit beyond tolerance "
                f"(latents rel L2 <= {E2E_LATENT_REL_L2}, image mean <= "
                f"{E2E_IMAGE_MEAN_LSB} LSB): {res}"
            )

    arms = {}
    for arm, override, key in (("default", {}, "default_b1"), ("opt_in", OPT_IN, "optin_b1")):
        inventory = launches_by_kernel(calls[key])
        reset_launch_counts()
        kern = run(**override)  # a new key: eager warm-up, capture, replay
        launches = launch_counts()
        check_launches(f"one edit on graphs (a new key), {arm} configuration", launches,
                       {k: 2 * n for k, n in inventory.items()})
        reset_launch_counts()
        eager = run(cuda_graphs=False, **override)
        check_launches(f"one edit on the eager arm, {arm} configuration", launch_counts(),
                       inventory)
        same_bits(f"{arm} configuration", kern, eager)
        before = launch_counts()
        plain = run(plain_versions=True, **override)
        if launch_counts() != before:
            raise AssertionError("a plain-version edit launched a kernel")
        res = dict(differ(kern, plain), image_std=float(plain[0].std()),
                   latent_std=float(plain[1].float().std()), seconds_graphs_first_call=kern[2],
                   seconds_eager=eager[2], seconds_plain=plain[2],
                   stage_ms_graphs=kern[3], stage_ms_eager=eager[3], launches=launches)
        log(f"kernels vs plain end to end, {arm} configuration:", res)
        within_limits(arm, res)
        if res["latent_std"] == 0.0:
            raise AssertionError("seeded-weight edit gave constant latents")
        arms[arm] = res
        if arm == "default":
            before = launch_counts()
            arms["planted_faults"] = faults = {
                kind: differ(run(kind, plain_versions=True), plain)
                for kind in ("attention", "conv")}
            if launch_counts() != before:
                raise AssertionError("a plain-version edit launched a kernel")
            log("planted faults, plain edits against the plain edit:", faults)
            conv_fault = faults["conv"]
            if (conv_fault["latent_rel_l2"] <= E2E_LATENT_REL_L2
                    or conv_fault["image_mean_abs_lsb"] <= E2E_IMAGE_MEAN_LSB):
                raise AssertionError(
                    f"the end-to-end tolerance passes a planted conv fault: {conv_fault}")
    torch.cuda.synchronize()
    return arms


# ------------------------------------------------------------------ phase 5


def graphs_vs_eager(editor) -> dict:
    """Graphs against the eager arm, bit for bit, on the seeded weights of
    phase 4."""
    from fastedit_tpu_torch.ops import flags

    images, prompts = [test_image(6), test_image(7)], ["a red barn", "a lake at dawn"]
    captured = editor._graphs.captured
    out = {}

    def pair(what, imgs, prm, **kw):
        graph = edit_arrays(editor, imgs, prm, **kw)
        with flags.override(cuda_graphs=False):
            eager = edit_arrays(editor, imgs, prm, **kw)
        same_bits(what, graph, eager)
        out[what] = dict(seconds_graphs=graph[2], seconds_eager=eager[2],
                         stage_ms_graphs=graph[3], stage_ms_eager=eager[3],
                         keys=len(captured), image_std=float(graph[0].std()))
        log(f"graphs = eager, {what}:", out[what])

    pair("batch 1, CFG", images[:1], prompts[:1], seed=21, **EDIT_KW)
    pair("batch 1, no CFG", images[:1], prompts[:1], seed=22,
         **{**EDIT_KW, "guidance_scale": 1.0})
    pair("edit_batch of 2", images, prompts, seed=23, **EDIT_KW)
    keys = len(captured)
    # the batch-1 CFG key again: another image, prompt, seed, schedule (5 steps at
    # strength 0.6 run 3, from t = 599) and scales
    pair("batch 1, CFG, a second replay on new inputs", [test_image(8)], ["a desert road"],
         seed=24, strength=0.6, num_inference_steps=5, guidance_scale=2.0,
         controlnet_conditioning_scale=0.8)
    if len(captured) != keys:
        raise AssertionError("new inputs of a captured key captured another key")
    with flags.override(use_fused_down2=False):
        pair("flags override use_fused_down2=False", images[:1], prompts[:1], seed=25,
             **EDIT_KW)
    if len(captured) != keys + 1:
        raise AssertionError("a flags override did not capture a new key")
    return out


# ------------------------------------------------------------------ phase 6

# SSD-1B's five models as a diffusers / transformers snapshot: component ->
# (its file's name, the converter's --expect name or None).
SNAPSHOT = {
    "unet": ("diffusion_pytorch_model.fp16.safetensors", "ssd-1b"),
    "controlnet": ("diffusion_pytorch_model.fp16.safetensors", "controlnet-small"),
    "vae": ("diffusion_pytorch_model.fp16.safetensors", "vae"),
    "text_encoder": ("model.fp16.safetensors", None),
    "text_encoder_2": ("model.fp16.safetensors", None),
}
LORA_RANK, LORA_ALPHA = 64, 32.0
LORA_PROJECTIONS = (".to_q", ".to_k", ".to_v", ".to_out.0")
# calculate_all_metrics_batch against the per-pair calls (the JAX package's
# own test of the batch: tests/test_metrics_batch.py)
METRICS_BATCH_RTOL, METRICS_BATCH_ATOL = 2e-4, 2e-5


def snapshot_configs() -> dict:
    """The public ``config.json`` of each SSD-1B component (the port's
    vendored copies)."""
    from fastedit_tpu_torch.tools import hf_vendored as V

    return {"unet": V.SSD1B_UNET_CONFIG, "controlnet": V.CONTROLNET_SMALL_CONFIG,
            "vae": V.VAE_CONFIG, "text_encoder": V.CLIP_VIT_L_TEXT_CONFIG,
            "text_encoder_2": V.CLIP_BIGG_TEXT_CONFIG}


def write_hf_snapshot(mod, out: Path, configs: dict, dtype) -> int:
    """Each model of ``mod`` (``PipelineModules``' five) as an HF snapshot
    component under ``out``: ``config.json`` from ``configs`` and its state
    dict (diffusers / transformers names) in ``dtype``, written by the port's
    safetensors writer.  Returns the bytes written."""
    from fastedit_tpu_torch.utils.safetensors_io import save_file

    nbytes = 0
    for name, (filename, _) in SNAPSHOT.items():
        path = out / name
        path.mkdir(parents=True)
        (path / "config.json").write_text(json.dumps(configs[name], indent=2))
        sd = {k: v.to(dtype) for k, v in getattr(mod, name).state_dict().items()}
        save_file(sd, str(path / filename))
        nbytes += (path / filename).stat().st_size
    return nbytes


def write_tokenizer(path: Path, vocab_size: int = 49408) -> None:
    """A small CLIP BPE vocabulary: the byte-level alphabet, each symbol
    also word-final, a few merges, and ``<|startoftext|>`` /
    ``<|endoftext|>`` as the last two ids (49406 / 49407 at CLIP's size)."""
    from fastedit_tpu_torch.text.tokenizer import bytes_to_unicode

    chars = list(bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    vocab.update({c + "</w>": len(chars) + i for i, c in enumerate(chars)})
    merges = [("t", "h"), ("th", "e</w>"), ("a", "n"), ("an", "d</w>"), ("i", "n"),
              ("o", "f</w>"), ("e", "r</w>"), ("a", "t</w>")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = vocab_size - 2, vocab_size - 1
    path.mkdir(parents=True, exist_ok=True)
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))


def kohya_lora(unet, seed: int, rank: int = LORA_RANK, alpha: float = LORA_ALPHA) -> dict:
    """A seeded rank-``rank`` LoRA over every attention projection of
    ``unet`` in the kohya dialect (``lora_unet_<module>.lora_down.weight``,
    ``.lora_up.weight``, ``.alpha``), fp32 on the host; the fused update
    alpha / rank * up @ down moves a weight by ~10% of its RMS."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, m in unet.named_modules():
        if not name.endswith(LORA_PROJECTIONS):
            continue
        n_out, n_in = m.weight.shape
        key = "lora_unet_" + name.replace(".", "_")
        out[f"{key}.lora_down.weight"] = torch.randn((rank, n_in), generator=gen) * n_in**-0.5
        out[f"{key}.lora_up.weight"] = torch.randn((n_out, rank), generator=gen) * (
            0.1 * rank / alpha * rank**-0.5)
        out[f"{key}.alpha"] = torch.tensor(alpha)
    return out


def fuse_lora_(unet, lora: dict) -> None:
    """The LoRA fused into ``unet``'s weights in place, in fp32 on the
    card: W = bf16(W + alpha / rank * up @ down)."""
    import torch

    with torch.no_grad():
        for name, m in unet.named_modules():
            if name.endswith(LORA_PROJECTIONS):
                m.weight.copy_(lora_reference(m.weight, lora, name))


def lora_reference(weight, lora: dict, module: str):
    """W + alpha / rank * up @ down in fp32 on ``weight``'s device."""
    key = "lora_unet_" + module.replace(".", "_")
    down = lora[f"{key}.lora_down.weight"].to(weight.device)
    up = lora[f"{key}.lora_up.weight"].to(weight.device)
    return weight.float() + float(lora[f"{key}.alpha"]) / down.shape[0] * (up @ down)


def convert_all(snap: Path, ckpt: Path, lora_file: Path, card: str) -> dict:
    """``python -m fastedit_tpu_torch.tools.convert_checkpoint`` on every
    component, the tokenizers, and the UNet again with the LoRA fused (into
    ``ckpt / "lora"``), all started together; each snapshot component is
    deleted once its conversions are done.  Returns seconds per conversion."""
    import shutil

    expect = {name: ["--expect", e] if e else [] for name, (_, e) in SNAPSHOT.items()}
    jobs = {name: [name, "--src", str(snap / name), "--out", str(ckpt / name), *expect[name]]
            for name in SNAPSHOT}
    jobs["unet+lora"] = ["unet", "--src", str(snap / "unet"), "--out",
                         str(ckpt / "lora" / "unet"), "--lora", str(lora_file), *expect["unet"]]
    for tok in ("tokenizer", "tokenizer_2"):
        jobs[tok] = ["tokenizer", "--src", str(snap / tok), "--out", str(ckpt / tok)]
    # one thread each (torch's and BLAS's): the jobs share the machine's cores, and a
    # job's copies and casts gain little from more threads than its own
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs, seconds, logs = {}, {}, {}
    deadline = time.perf_counter() + 600
    try:
        for name, args in jobs.items():
            logs[name] = ckpt.parent / f"convert_{name}.log"
            with open(logs[name], "w") as out:
                procs[name] = (time.perf_counter(), subprocess.Popen(
                    [sys.executable, "-m", "fastedit_tpu_torch.tools.convert_checkpoint", *args],
                    cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT))
        while len(seconds) < len(procs):  # each job's own seconds, as it ends
            if time.perf_counter() > deadline:
                raise AssertionError(f"conversions still running after 600 s: "
                                     f"{sorted(set(procs) - set(seconds))}")
            for name, (t0, proc) in procs.items():
                if name in seconds or proc.poll() is None:
                    continue
                seconds[name] = time.perf_counter() - t0
                if proc.returncode:
                    raise AssertionError(f"converting {name} failed ({proc.returncode}):\n"
                                         f"{logs[name].read_text()}")
                if name in SNAPSHOT and name != "unet":
                    shutil.rmtree(snap / name)
            time.sleep(0.05)
        shutil.rmtree(snap / "unet")
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, path in logs.items():
        log(f"  convert {name}: {seconds[name]:.2f} s; {card};",
            path.read_text().strip().splitlines()[-1])
    return seconds


def edit_one(editor, img, prompt: str, **kw):
    """One ``edit``: (uint8 image [1, r, r, 3], final latents, host seconds,
    device ms per stage)."""
    import numpy as np

    t = time.perf_counter()
    out = editor.edit(img, prompt, **kw)
    sec = time.perf_counter() - t
    lat = editor.last_latents.clone()
    if not bool(lat.isfinite().all()):
        raise AssertionError("non-finite final latents")
    return np.asarray(out)[None], lat, sec, editor.stage_ms()


def fp16_round_trip_(editor) -> None:
    """Every weight through bf16 -> fp16 -> bf16 (fp32 norms: fp32 -> fp16
    -> bf16 -> fp32), what the fp16 snapshot and its bf16 conversion do to
    it."""
    import torch

    mod = editor.modules
    with torch.no_grad():
        for name in SNAPSHOT:
            for p in getattr(mod, name).parameters():
                p.copy_(p.half().bfloat16())
    editor.clear_memory()


def checkpoint_and_metrics(editor, calls: dict, card: str) -> dict:
    """Phase 6 on the seeded-weight SSD-1B editor of phases 4 and 5."""
    import shutil

    import torch

    from fastedit_tpu_torch import FastEditor
    from fastedit_tpu_torch.text.tokenizer import CLIPTokenizer
    from fastedit_tpu_torch.tools import from_jax
    from fastedit_tpu_torch.tools.inventory import (
        launch_counts, launches_by_kernel, reset_launch_counts)
    from fastedit_tpu_torch.utils import checkpoint as ckpt_io
    from fastedit_tpu_torch.utils.safetensors_io import save_file

    work = ROOT / "build" / "chip_smoke_checkpoint"
    shutil.rmtree(work, ignore_errors=True)
    snap, ckpt = work / "snapshot", work / "converted"
    res: dict = {}
    try:
        t = time.perf_counter()
        written = write_hf_snapshot(editor.modules, snap, snapshot_configs(), torch.float16)
        for tok in ("tokenizer", "tokenizer_2"):
            write_tokenizer(snap / tok)
        lora = kohya_lora(editor.modules.unet, seed=6)
        save_file(lora, str(work / "lora.safetensors"))
        res["snapshot_write_s"] = time.perf_counter() - t
        res["convert_s"] = convert_all(snap, ckpt, work / "lora.safetensors", card)
        written += sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
        res["gib_written"] = written / 1024**3
        for name in (*SNAPSHOT, "tokenizer", "tokenizer_2"):  # the LoRA checkpoint's others
            if name != "unet":
                (ckpt / "lora" / name).symlink_to(ckpt / name, target_is_directory=True)
        log(f"snapshot written in {res['snapshot_write_s']:.2f} s; {res['gib_written']:.2f} "
            f"GiB written in all (fp16 snapshot and bf16 conversions); {card}")

        t = time.perf_counter()
        loaded = FastEditor("ssd-1b", checkpoint_dir=str(ckpt))
        torch.cuda.synchronize()
        res["load_s"] = time.perf_counter() - t
        log(f"FastEditor('ssd-1b', checkpoint_dir=...) loaded in {res['load_s']:.2f} s; {card}")

        fp16_round_trip_(editor)  # nothing but I/O differs from the loaded editor now
        editor.tokenizer = CLIPTokenizer.from_dir(str(ckpt / "tokenizer"))
        editor.tokenizer_2 = CLIPTokenizer.from_dir(str(ckpt / "tokenizer_2"), pad_token_id=0)
        img, prompt = test_image(9), "the harbor and the boats at dusk"
        images, prompts = [test_image(10), test_image(11)], ["a street in the rain",
                                                             "an orchard in autumn"]
        runs = {"edit": lambda ed: edit_one(ed, img, prompt, seed=41, **EDIT_KW),
                "edit_batch of 2": lambda ed: edit_arrays(ed, images, prompts, seed=42,
                                                          **EDIT_KW)}
        per_edit = launches_by_kernel(calls["default_b1"])
        per_batch2 = launches_by_kernel(calls["default_b2"])
        reset_launch_counts()
        outs = {what: run(loaded) for what, run in runs.items()}
        check_launches("the loaded editor's first edit and edit_batch of 2 (an eager warm-up "
                       "and a capture each)", launch_counts(),
                       {k: 2 * (per_edit[k] + per_batch2[k]) for k in per_edit})
        for what, run in runs.items():
            got, ref = outs[what], run(editor)
            same_bits(f"loaded checkpoint against the in-memory editor, {what}", got, ref)
            res[what] = dict(seconds_loaded=got[2], seconds_in_memory=ref[2],
                             stage_ms_loaded=got[3], image_std=float(got[0].std()))
            log(f"loaded = in-memory bit for bit, {what}:", res[what])
        res["replay_launches"] = wrapper_launches(device_kernels(
            lambda: loaded.edit(img, prompt, seed=43, **EDIT_KW), calls=2))
        check_launches("one replayed edit of the loaded editor, device kernels by the profiler",
                       res["replay_launches"], {**per_edit, "up2_phase_weights": 0})
        del loaded
        torch.cuda.empty_cache()

        # LoRA: the fused tensors against W + alpha / rank * up @ down in fp32 on the card
        unet = editor.modules.unet
        fused_sd = from_jax.unet_state_dict(
            ckpt_io.load_params(str(ckpt / "lora" / "unet")), unet.cfg)
        worst, n_lora = 0.0, 0
        for name, m in unet.named_modules():
            if not name.endswith(LORA_PROJECTIONS):
                continue
            ref = lora_reference(m.weight, lora, name)
            got = fused_sd[f"{name}.weight"].to(ref.device)
            err, _ = check_close(f"LoRA-fused {name}", got, ref, CONV_REL, conv_tol(ref))
            if n_outside(m.weight, ref, CONV_REL, conv_tol(ref)) == 0:
                raise AssertionError(f"{name}: the tolerance passes the unfused weight")
            worst, n_lora = max(worst, err), n_lora + 1
        del fused_sd
        res["lora"] = dict(modules=n_lora, rank=LORA_RANK, alpha=LORA_ALPHA,
                           max_abs_err=worst)
        lora_editor = FastEditor("ssd-1b", checkpoint_dir=str(ckpt / "lora"))
        fuse_lora_(unet, lora)
        editor.clear_memory()
        got = edit_one(lora_editor, img, prompt, seed=44, **EDIT_KW)
        ref = edit_one(editor, img, prompt, seed=44, **EDIT_KW)
        res["lora"].update(differ(got, ref), against_unfused=differ(got, outs["edit"]))
        log("LoRA-fused checkpoint against the in-memory fuse:", res["lora"])
        if (res["lora"]["latent_rel_l2"] > E2E_LATENT_REL_L2
                or res["lora"]["image_mean_abs_lsb"] > E2E_IMAGE_MEAN_LSB):
            raise AssertionError(f"LoRA-fused checkpoint edit differs from the in-memory fuse "
                                 f"beyond {E2E_LATENT_REL_L2} / {E2E_IMAGE_MEAN_LSB}: {res['lora']}")
        lora_image = got[0][0]
        del lora_editor
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    res["metrics"] = metrics_on_card(
        [img] + images + [test_image(12)],
        [outs["edit"][0][0], *outs["edit_batch of 2"][0], lora_image],
        [prompt, *prompts, "a lighthouse"], card)
    return res


def metrics_on_card(sources: list, edited_arrays: list, prompts: list, card: str) -> dict:
    """``MetricsCalculator(allow_random=True)`` at full width (CLIP ViT-B/16,
    DINO ViT-B/8, LPIPS-Squeeze at 512²) on four (source, edited, prompt)
    triples."""
    import math

    import torch
    from PIL import Image

    from fastedit_tpu_torch.metrics import MetricsCalculator

    edited = [Image.fromarray(a) for a in edited_arrays]
    t = time.perf_counter()
    calc = MetricsCalculator(weights_dir=str(ROOT / "build" / "no_metrics_weights"),
                             allow_random=True)
    res = dict(init_s=time.perf_counter() - t)
    if calc.device.type != "cuda" or calc.random_backbones != (
            "lpips", "clip_vision", "clip_text", "dino"):
        raise AssertionError(f"metrics on {calc.device}, random {calc.random_backbones}")
    calc.calculate_all_metrics(sources[0], edited[0], prompts[0])  # random weights made here
    torch.cuda.synchronize()
    t = time.perf_counter()
    pairs = [calc.calculate_all_metrics(s, e, p) for s, e, p in zip(sources, edited, prompts)]
    res["ms_per_pair"] = 1e3 * (time.perf_counter() - t) / len(pairs)
    calc.calculate_all_metrics_batch(sources, edited, prompts)
    t = time.perf_counter()
    batch = calc.calculate_all_metrics_batch(sources, edited, prompts)
    res["ms_per_batch_of_4"] = 1e3 * (time.perf_counter() - t)
    for i, (one, many) in enumerate(zip(pairs, batch, strict=True)):
        for k, v in one.items():
            if not math.isfinite(v):
                raise AssertionError(f"pair {i}: {k} = {v}")
            if abs(many[k] - v) > METRICS_BATCH_ATOL + METRICS_BATCH_RTOL * abs(v):
                raise AssertionError(f"pair {i}: {k} batched {many[k]} against {v}")
    same = dict(ssim=calc.calculate_ssim(sources[0], sources[0]),
                psnr=calc.calculate_psnr(sources[0], sources[0]),
                mse=calc.calculate_mse(sources[0], sources[0]))
    if same != dict(ssim=1.0, psnr=math.inf, mse=0.0):
        raise AssertionError(f"an image against itself: {same}")
    res.update(pairs=pairs, image_with_itself=same)
    log(f"metrics (random backbones at full width): {res['ms_per_pair']:.2f} ms per pair, "
        f"{res['ms_per_batch_of_4']:.2f} ms per batch of 4; {card}; first pair {pairs[0]}")
    del calc
    torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------------- main


KERNELS = {  # name: (source, TPU kernel it replaces: file:line of pallas_call)
    "conv3x3": ("fastedit_tpu_torch/csrc/conv3x3.cu", "fastedit_tpu/ops/conv3x3.py:169"),
    "flash_attention_d64": ("fastedit_tpu_torch/csrc/flash_attention.cu",
                            "fastedit_tpu/ops/flash_attention.py:253"),
    "flash_attention_d512": ("fastedit_tpu_torch/csrc/flash_attention.cu",
                             "fastedit_tpu/ops/flash_attention.py:97"),
    "conv3x3_up2": ("fastedit_tpu_torch/csrc/conv3x3.cu", "fastedit_tpu/ops/conv_fused.py:433"),
    "conv3x3_down2": ("fastedit_tpu_torch/csrc/conv3x3.cu",
                      "fastedit_tpu/ops/conv_fused.py:610"),
    "conv3x3_fused": ("fastedit_tpu_torch/csrc/conv3x3.cu",
                      "fastedit_tpu/ops/conv_fused.py:221"),
    "group_norm": ("fastedit_tpu_torch/csrc/group_norm.cu",
                   "fastedit_tpu/ops/fused_groupnorm.py:105"),
    # the statistics launch alone; in the JAX package an XLA function
    "group_norm_scale_shift": ("fastedit_tpu_torch/csrc/group_norm.cu",
                               "fastedit_tpu/ops/groupnorm.py:53"),
}
# Kernels built on wgmma (SASS HGMMA), by a part of their mangled name; the
# only other one (the upsample conv's phase-weight fold) must hold none.
WGMMA_KERNELS = ("conv3x3_kernel", "conv3x3_fused_kernel", "conv3x3_down2_kernel",
                 "conv3x3_up2_kernel", "flash_d64_kernel", "flash_d512_kernel")



def kernel_summary(rows: list, main: dict) -> list:
    """One entry per kernel.  Times and bounds are for one edit's calls of
    that kernel: the sum over its shapes of calls per edit x per-call time,
    in the default configuration.  ``ms`` and ``library_ms`` are the
    device's own times, from CUDA graphs; ``eager_ms`` and
    ``library_eager_ms`` are the same from back-to-back eager calls, which
    read the host where a call is short; ``plain_ms`` is eager (the plain
    versions take milliseconds).  ``launches`` are the wrapper's counts over
    the main path's run, which on graphs are its two keys' first calls (an
    eager warm-up and a capture each); ``replay_launches`` are the device
    kernels of one replayed edit, by the profiler.  ``library_ms`` is null
    where no one PyTorch call computes the same function."""
    out = []
    for name, (source, replaces) in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        if not mine:
            raise AssertionError(f"no main-path shape reached {name}")

        def per_edit(key, mine=mine):
            return sum(r["calls_edit"] * r[key] for r in mine)

        ops_ms = 1e3 * per_edit("flops") / PEAK_BF16_FLOPS
        bytes_ms = 1e3 * per_edit("bytes") / PEAK_HBM_BYTES_PER_S
        launches = main["launches"][name]
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches, replay_launches=main["replay_launches"]["edit"][name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=per_edit("ms"), plain_ms=per_edit("plain_ms"), bound_ms=per_edit("bound_ms"),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            library_ms=None if mine[0]["library_ms"] is None else per_edit("library_ms"),
            eager_ms=per_edit("eager_ms"),
            library_eager_ms=(None if mine[0]["library_eager_ms"] is None
                              else per_edit("library_eager_ms")),
        ))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on a card",
              file=sys.stderr)
        return 2
    if not (ROOT / "fastedit_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no fastedit_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions are fp32 references
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    from fastedit_tpu_torch.ops import build
    from fastedit_tpu_torch.tools.timing import card_line

    card = card_line()
    log(card)
    log("torch", torch.__version__, "cuda", torch.version.cuda, torch.cuda.get_device_name(0))
    t = time.perf_counter()
    nvcc_logs = build.build_all()
    build_s = time.perf_counter() - t
    log(f"[1] kernels built in {build_s:.2f} s")
    for name, text in nvcc_logs.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line or "Compiling entry" in line
                    or "Performance Loss" in line):
                log(f"  {name}: {line.strip()}")
            # a kernel that spills, or whose wgmmas ptxas serialises (C7513,
            # C7520), still computes the right values: only this stops it
            if "Performance Loss" in line or (
                    "spill stores" in line and "0 bytes spill stores, 0 bytes spill loads"
                    not in line):
                raise AssertionError(f"{name}: ptxas reports {line.strip()}")

    hgmma = {}
    for lib in ("conv3x3", "flash_attention"):
        counts = count_hgmma(build.library_path(lib))
        hgmma.update(counts)
        for name, n in counts.items():
            on_wgmma = any(k in name for k in WGMMA_KERNELS)
            log(f"  {lib}: {n} HGMMA in {name}")
            if on_wgmma != (n > 0):
                raise AssertionError(f"{name}: {n} HGMMA instructions; {WGMMA_KERNELS}, and "
                                     "only they, are built on wgmma")
        if not counts:
            log(f"  {lib}: no cuobjdump, HGMMA not counted")

    log("[2] kernels vs plain versions at the main path's shapes")
    t = time.perf_counter()
    calls = kernel_shapes()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for compare in (compare_conv, compare_fused, compare_up2, compare_down2,
                    compare_group_norm, compare_attention):
        rows += compare(calls, gen)
        torch.cuda.empty_cache()
    host = host_us_per_launch(calls, gen)
    phase2_s = time.perf_counter() - t

    log("[3] main path: FastEditor('ssd-1b', random_weights=True) at 1024², on CUDA graphs")
    editor, main = main_path(calls)

    log("[4] kernels vs plain versions end to end, seeded weights")
    e2e = kernels_vs_plain(editor, calls)

    log("[5] graphs vs the eager arm")
    vs_eager = graphs_vs_eager(editor)

    log("[6] a converted checkpoint: snapshot, converter, FastEditor(checkpoint_dir=...), LoRA, "
        "metrics")
    t = time.perf_counter()
    phase6 = checkpoint_and_metrics(editor, calls, card)
    phase6["seconds"] = time.perf_counter() - t
    log(f"phase 6 took {phase6['seconds']:.1f} s; {card}")
    del editor
    torch.cuda.empty_cache()

    log("[bench] python -m fastedit_tpu_torch.bench --reps 3")
    from fastedit_tpu_torch import bench

    t = time.perf_counter()
    bench_record = bench.main(["--reps", "3"])
    bench_s = time.perf_counter() - t

    kernels = kernel_summary(rows, main)
    OUT_FILE.parent.mkdir(parents=True, exist_ok=True)
    OUT_FILE.write_text(json.dumps(dict(
        card=card, torch=torch.__version__, cuda=torch.version.cuda, kernels=kernels,
        shapes=rows, host=host, main_path=main, kernels_vs_plain=e2e,
        graphs_vs_eager=vs_eager, checkpoint_and_metrics=phase6, bench=bench_record,
        bench_s=bench_s,
        phase2_s=phase2_s, build_s=build_s, hgmma=hgmma,
        seconds_total=time.perf_counter() - t_start,
    ), indent=1, default=str))
    log(f"total {time.perf_counter() - t_start:.1f} s; details in {OUT_FILE.relative_to(ROOT)}")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
