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
   GroupNorm: a one-pass variance on an input with |mean| >> std), which the
   tolerance must reject.  The rows of the stride-1 and stride-2 convs and of
   attention also carry their plan (tiles, grid, shared memory) and the
   achieved TFLOP/s, and the host's microseconds per launch of the stride-1
   conv, the stride-2 conv and attention are printed.
3. The main path in the default configuration:
   ``FastEditor("ssd-1b", random_weights=True)`` at 1024², a warm-up, three
   ``edit()`` calls and one ``edit_batch`` of two images.  Seconds per edit
   and per stage, peak memory, and each kernel's launches, which must equal
   the inventory's counts.
4. Kernels against plain versions end to end, with seeded fan-in-scaled
   weights, in two arms: the default configuration, and the opt-in one
   (``use_cuda_conv=True``: the encoder on the conv, fused resnet and
   asymmetric stride-2 kernels; ``use_cuda_groupnorm=True``: the GroupNorm
   kernel).  Each arm: one edit with the kernels, whose launches must equal
   the inventory's, and one with ``flags.override(plain_versions=True)``;
   final latents and images compared.  Two plain edits with a planted fault
   (attention, conv) are read against the plain edit beside the limits.

It prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``.  Per-shape kernel figures and the main-path timings are also
written to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
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
# The opt-in kernel configuration of phase 4 (the path of the GroupNorm
# kernel and of the encoder's fused and stride-2 kernels).
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


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


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


def hold(calls, kernel, key, kern, plain, library, flops, nbytes, faults=None,
         extra=None) -> dict:
    """Check ``kern()`` against ``plain()`` with the conv tolerance (and every
    planted fault of ``faults``, by name, against it, which must fail), then
    time the kernel, the plain version and the library call.  One row of the
    per-shape table."""
    import torch

    from fastedit_tpu_torch.tools.timing import graph_ms, time_ms

    out, ref = kern(), plain()
    torch.cuda.synchronize()
    err, rel = check_close(f"{kernel} {key}", out, ref, CONV_REL, conv_tol(ref))
    row = dict(kernel=kernel, shape=list(key), max_abs_err=err, max_rel_err=rel)
    for name, make in (faults or {}).items():
        bad = n_outside(make(), ref, CONV_REL, conv_tol(ref))
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
        ms=graph_ms(kern), library_ms=graph_ms(library), plain_ms=time_ms(plain),
        eager_ms=time_ms(kern), library_eager_ms=time_ms(library),
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


def plan_of(x, cout: int, down2_asymmetric=None) -> dict:
    """The conv kernel's schedule for this call (stride 1, or stride 2 where
    ``down2_asymmetric`` says which padding), as a row records it."""
    from fastedit_tpu_torch.ops.conv3x3 import plan_down2_for, plan_for

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
    + ``F.conv2d``)."""
    import torch.nn.functional as F

    from fastedit_tpu_torch.ops import conv_fused as cf

    rows = []
    for key in keys_of(calls, "conv3x3_up2"):
        n, h, w, cin, cout = key
        x, wt, bias = _conv_operands(gen, n, h, w, cin, cout)
        phases = cf.make_phase_kernels(wt)
        swapped = phases.clone()
        swapped[1, 1] = phases[1, 1].flip(0)
        x_nchw, bias_bf = x.permute(0, 3, 1, 2), bias.bfloat16()

        def library():
            up = x_nchw.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            return F.conv2d(up, wt, bias_bf, padding=1)

        rows.append(hold(
            calls, "conv3x3_up2", key,
            lambda: cf.conv3x3_up2(x, wt, bias), lambda: cf.conv3x3_up2_plain(x, wt, bias),
            library, flops=32.0 * n * h * w * cin * cout,
            nbytes=2.0 * (n * h * w * cin + 9 * cin * cout + 4 * n * h * w * cout) + 4.0 * cout,
            faults={"fault": lambda: cf.up2_phases_plain(x, swapped, bias)},
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


def compare_group_norm(calls: dict, gen) -> list[dict]:
    """Two inputs per shape: normal values, held and timed; and the |mean|
    >> std input, held too, with the planted fault (a one-pass variance)
    read on it.  Library: ``F.group_norm`` (+ ``F.silu``) on channels_last
    NCHW."""
    import torch
    import torch.nn.functional as F

    from fastedit_tpu_torch.ops import fused_groupnorm as fg
    from fastedit_tpu_torch.ops.groupnorm import group_norm_plain

    def one_pass(x, gamma, beta, groups, act):
        b, h, w, c = x.shape
        xf = x.float().reshape(b, h * w, groups, c // groups)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = xf.square().mean(dim=(1, 3), keepdim=True) - mean.square()
        out = ((xf - mean) * torch.rsqrt(var + 1e-5)).reshape(b, h, w, c) * gamma + beta
        return (F.silu(out) if act == "silu" else out).bfloat16()

    rows = []
    for key in keys_of(calls, "group_norm"):
        n, h, w, c, groups, act = key
        gamma = torch.randn(c, generator=gen, device="cuda") * 0.5 + 1.0
        beta = torch.randn(c, generator=gen, device="cuda") * 0.2
        spikes = torch.rand((n, h, w, c), generator=gen, device="cuda") < GN_SPIKE_RATE
        offset = (GN_OFFSET + GN_SPIKE * spikes.float()).bfloat16()
        del spikes
        out = fg.fused_group_norm(offset, gamma, beta, groups, 1e-5, act)
        ref = group_norm_plain(offset, gamma, beta, groups, 1e-5, act)
        torch.cuda.synchronize()
        off_err, _ = check_close(f"group_norm {key}, |mean| >> std", out, ref, CONV_REL,
                                 conv_tol(ref))
        fault_bad = n_outside(one_pass(offset, gamma, beta, groups, act), ref, CONV_REL,
                              conv_tol(ref))
        del out, ref, offset
        if fault_bad == 0:
            raise AssertionError(f"group_norm {key}: the tolerance passes a one-pass variance")

        x = (torch.randn((n, h, w, c), generator=gen, device="cuda") * 2.0 + 0.5).bfloat16()
        x_nchw = x.permute(0, 3, 1, 2)
        g_bf, b_bf = gamma.bfloat16(), beta.bfloat16()

        def library():
            y = F.group_norm(x_nchw, groups, g_bf, b_bf, 1e-5)
            return F.silu(y) if act == "silu" else y

        elems = n * h * w * c
        rows.append(hold(
            calls, "group_norm", key,
            lambda: fg.fused_group_norm(x, gamma, beta, groups, 1e-5, act),
            lambda: group_norm_plain(x, gamma, beta, groups, 1e-5, act),
            library, flops=8.0 * elems, nbytes=4.0 * elems + 8.0 * c,
            extra=dict(offset_max_abs_err=off_err, fault_elements_outside=fault_bad),
        ))
    return rows


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
            plan=dict(bq=pl.bq, bkv=pl.bkv, stages=pl.stages, tiles=pl.tiles, grid=pl.grid,
                      smem_bytes=pl.smem_bytes),
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


def launch_counts() -> dict:
    from fastedit_tpu_torch.ops import conv3x3, conv_fused, flash_attention, fused_groupnorm

    return {"conv3x3": conv3x3.launches, **conv_fused.launches,
            "group_norm": fused_groupnorm.launches,
            **{f"flash_attention_d{d}": n for d, n in flash_attention.launches.items()}}


def reset_launch_counts() -> None:
    from fastedit_tpu_torch.ops import conv3x3, conv_fused, flash_attention, fused_groupnorm

    conv3x3.launches = 0
    fused_groupnorm.launches = 0
    for counts in (conv_fused.launches, flash_attention.launches):
        for k in counts:
            counts[k] = 0


def check_launches(what: str, launches: dict, expected: dict) -> None:
    """Every kernel's launches equal the inventory's, and every kernel the
    inventory expects was launched."""
    log(f"launches ({what}):", launches, "expected:", expected)
    for name, n in expected.items():
        if launches.get(name) != n:
            raise AssertionError(f"{what}: {name} launched {launches.get(name)} times, "
                                 f"expected {n}")


def check_image(img) -> None:
    import numpy as np

    arr = np.asarray(img)
    if arr.dtype != np.uint8 or arr.shape != (RESOLUTION, RESOLUTION, 3):
        raise AssertionError(f"edit returned {arr.dtype} {arr.shape}")


def main_path(calls: dict):
    import torch

    from fastedit_tpu_torch import FastEditor
    from fastedit_tpu_torch.tools.inventory import launches_by_kernel
    from fastedit_tpu_torch.tools.profile_edit import StageTimer

    t0 = time.perf_counter()
    editor = FastEditor("ssd-1b", random_weights=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    warm_s = editor.warmup(**EDIT_KW)
    log(f"editor built in {build_s:.2f} s, warm-up edit {warm_s:.2f} s")

    timer = StageTimer()
    images = [test_image(1), test_image(2)]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    edits = []
    for i in range(3):
        t = time.perf_counter()
        out = editor.edit(images[0], "a watercolor painting of a harbor", seed=i, **EDIT_KW)
        edits.append(dict(seconds=time.perf_counter() - t, stage_ms=timer.take()))
        check_image(out)
        log(f"edit {i}: {edits[-1]['seconds']:.4f} s", edits[-1]["stage_ms"])
    t = time.perf_counter()
    outs = editor.edit_batch(images, ["a snowy street", "a city at night"], seed=3, **EDIT_KW)
    batch = dict(seconds=time.perf_counter() - t, stage_ms=timer.take())
    for out in outs:
        check_image(out)
    log(f"edit_batch of 2: {batch['seconds']:.4f} s", batch["stage_ms"])
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 1024**3

    per_edit = launches_by_kernel(calls["default_b1"])
    per_batch2 = launches_by_kernel(calls["default_b2"])
    expected = {k: 3 * per_edit[k] + per_batch2[k] for k in per_edit}
    check_launches("3 edits + a batch of 2, default configuration", launches, expected)
    log(f"peak device memory {peak_gib:.3f} GiB")
    return editor, timer, dict(
        editor_build_s=build_s, warmup_s=warm_s, edits=edits, edit_batch2=batch,
        launches=launches, launches_per_edit=per_edit, peak_gib=peak_gib,
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


def kernels_vs_plain(editor, timer, calls: dict) -> dict:
    import numpy as np
    import torch

    from fastedit_tpu_torch.ops import flags
    from fastedit_tpu_torch.tools.inventory import launches_by_kernel

    seeded_weights_(editor, seed=20261016)
    img, prompt = test_image(5), "an oil painting of a lighthouse"
    editor.edit(img, prompt, seed=11, **EDIT_KW)  # encodes the prompt
    timer.take()

    def run(fault=None, **override):
        with flags.override(**override), (planted_fault(fault) if fault
                                          else contextlib.nullcontext()):
            t = time.perf_counter()
            out = np.asarray(editor.edit(img, prompt, seed=11, **EDIT_KW), np.int32)
            sec = time.perf_counter() - t
        stage_ms = timer.take()
        if not bool(timer.last_latents.isfinite().all()):
            raise AssertionError("non-finite final latents")
        return out, timer.last_latents, sec, stage_ms

    def differ(a, b) -> dict:
        diff = np.abs(a[0] - b[0])
        return dict(latent_rel_l2=float((a[1] - b[1]).norm() / b[1].norm()),
                    image_mean_abs_lsb=float(diff.mean()), image_max_abs_lsb=int(diff.max()))

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
        reset_launch_counts()
        kern = run(**override)
        launches = launch_counts()
        check_launches(f"one edit, {arm} configuration", launches,
                       launches_by_kernel(calls[key]))
        plain = run(plain_versions=True, **override)
        if launch_counts() != launches:
            raise AssertionError("a plain-version edit launched a kernel")
        res = dict(differ(kern, plain), image_std=float(plain[0].std()),
                   latent_std=float(plain[1].std()), seconds_kernels=kern[2],
                   seconds_plain=plain[2], stage_ms_kernels=kern[3], launches=launches)
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
}
# Kernels built on wgmma (SASS HGMMA), by a part of their mangled name; the
# others (up2, attention at D = 512, the phase-weight fold) must hold none.
WGMMA_KERNELS = ("conv3x3_kernel", "conv3x3_fused_kernel", "conv3x3_down2_kernel",
                 "flash_d64_kernel")
# Kernels off in the default configuration: their per-edit figures and
# launches come from the opt-in configuration's edit (phase 4).
OPT_IN_ONLY = ("group_norm",)


def kernel_summary(rows: list, main: dict, e2e: dict) -> list:
    """One entry per kernel.  Times and bounds are for one edit's calls of
    that kernel: the sum over its shapes of calls per edit x per-call time,
    in the default configuration (the opt-in one for ``OPT_IN_ONLY``).
    ``ms`` and ``library_ms`` are the device's own times, from CUDA graphs;
    ``eager_ms`` and ``library_eager_ms`` are the same from back-to-back eager
    calls, which read the host where a call is short; ``plain_ms`` is eager
    (the plain versions take milliseconds).
    Launches are those of the main path's run (3 edits and a batch of 2),
    or of the opt-in edit for ``OPT_IN_ONLY``."""
    out = []
    for name, (source, replaces) in KERNELS.items():
        opt_in = name in OPT_IN_ONLY
        calls_key = "calls_edit_optin" if opt_in else "calls_edit"
        mine = [r for r in rows if r["kernel"] == name]
        if not mine:
            raise AssertionError(f"no main-path shape reached {name}")

        def per_edit(key, mine=mine, calls_key=calls_key):
            return sum(r[calls_key] * r[key] for r in mine)

        ops_ms = 1e3 * per_edit("flops") / PEAK_BF16_FLOPS
        bytes_ms = 1e3 * per_edit("bytes") / PEAK_HBM_BYTES_PER_S
        launches = (e2e["opt_in"]["launches"] if opt_in else main["launches"])[name]
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches, max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=per_edit("ms"), plain_ms=per_edit("plain_ms"), bound_ms=per_edit("bound_ms"),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            library_ms=per_edit("library_ms"), eager_ms=per_edit("eager_ms"),
            library_eager_ms=per_edit("library_eager_ms"),
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

    log("[3] main path: FastEditor('ssd-1b', random_weights=True) at 1024²")
    editor, timer, main = main_path(calls)

    log("[4] kernels vs plain versions end to end, seeded weights")
    e2e = kernels_vs_plain(editor, timer, calls)
    timer.remove()

    kernels = kernel_summary(rows, main, e2e)
    OUT_FILE.parent.mkdir(parents=True, exist_ok=True)
    OUT_FILE.write_text(json.dumps(dict(
        card=card, torch=torch.__version__, cuda=torch.version.cuda, kernels=kernels,
        shapes=rows, host=host, main_path=main, kernels_vs_plain=e2e,
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
