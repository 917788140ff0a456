"""Fused resnet conv, nearest-2x upsample conv and stride-2 conv, NHWC:
CUDA kernel wrappers and their plain versions.

The kernels live in ``csrc/conv3x3.cu`` beside the 3x3 conv they extend and
replace the three TPU kernels of ``fastedit_tpu/ops/conv_fused.py``:

* ``conv3x3_fused`` (``_fused_call``): 3x3 SAME conv whose input is mapped
  through ``silu(x * scale[b, c] + shift[b, c])`` first (GroupNorm + SiLU,
  statistics from ``ops/groupnorm.group_norm_scale_shift``; the kernel does
  it once per staged halo element, on the schedule of ``conv3x3.plan``), with a
  per-batch bias [B, Cout] (the time-embedding add folded in), an optional
  SiLU and a skip-add epilogue: a resnet block's activations make one trip
  through HBM per conv.
* ``conv3x3_up2`` (``_up2_call``): nearest-2x upsample + 3x3 SAME conv as
  four 2x2 phase convs on the low-res input, without the 4x tensor and at
  16/36 of the FLOPs; the kernel folds the phase weights
  (:func:`make_phase_kernels`) itself, in the same call.
* ``conv3x3_down2`` (``_down2_call``): stride-2 3x3 conv with padding (1, 1)
  (UNet/ControlNet downsamplers) or (0, 1) (the VAE encoder's), on the
  stride-1 kernel's core: per parity plane of the input a tap is a rectangle
  shift (``conv3x3.plan_down2``; :func:`conv3x3_down2_tiled_plain` walks that
  schedule in plain PyTorch, for the tests).

Layouts as in ``ops/conv3x3.py``: ``x`` NHWC, ``weight`` PyTorch's OIHW in
channels_last memory.  A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from fastedit_tpu_torch.ops.conv3x3 import CHUNK, plan_down2, plan_down2_for, plan_for
from fastedit_tpu_torch.ops.conv3x3 import supports as _supports_conv3x3

# Launches of each CUDA kernel since the last reset (chip_smoke.py resets them).
launches = {"conv3x3_fused": 0, "conv3x3_up2": 0, "conv3x3_down2": 0}


def supports_fused(x_shape, w_shape) -> bool:
    """The gate of all three kernels is the conv kernel's: 3x3, Cin >= 64
    and Cin % 8 == 0.  The JAX package's VMEM tile budget admits every
    main-path call and does not carry over."""
    return _supports_conv3x3(x_shape, w_shape)


def supports_up2(x_shape, w_shape) -> bool:
    return _supports_conv3x3(x_shape, w_shape)


def supports_down2(x_shape, w_shape) -> bool:
    """As :func:`supports_fused`, and even H and W."""
    return (_supports_conv3x3(x_shape, w_shape)
            and x_shape[1] % 2 == 0 and x_shape[2] % 2 == 0)


def _finish(out: torch.Tensor, bias, act) -> torch.Tensor:
    """fp32 bias [Cout] or [B or 1, Cout], then optional SiLU (NHWC out)."""
    if bias is not None:
        b = bias.float()
        out = out + (b[:, None, None, :] if b.dim() == 2 else b)
    if act == "silu":
        out = F.silu(out)
    elif act is not None:
        raise ValueError(f"unsupported activation {act!r}")
    return out


def _nchw_f32(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).float()


def prologue_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """silu(x * scale + shift) in fp32 with [B, C] scale and shift, rounded
    to x.dtype (the rounding the kernel makes before its MMAs)."""
    y = x.float() * scale.float()[:, None, None, :] + shift.float()[:, None, None, :]
    return F.silu(y).to(x.dtype)


def conv3x3_fused_plain(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    prenorm: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    act: Optional[str] = None,
    skip: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The fused kernel's function in plain PyTorch: prologue (rounded to
    x.dtype), fp32 conv with zero padding of the *normalised* tensor, fp32
    bias, SiLU, skip, one rounding to x.dtype."""
    xin = x if prenorm is None else prologue_plain(x, *prenorm)
    out = F.conv2d(_nchw_f32(xin), weight.float(), padding=1).permute(0, 2, 3, 1)
    out = _finish(out, bias, act)
    if skip is not None:
        out = out + skip.float()
    return out.to(x.dtype).contiguous()


def make_phase_kernels(weight: torch.Tensor) -> torch.Tensor:
    """OIHW [Cout, Cin, 3, 3] -> phase weights [2, 2, 2, 2, Cout, Cin]
    (p, q, a, b): output pixel (2i+p, 2j+q) of upsample-then-conv is
    sum_{a,b} K[p, q, a, b] . x[i - 1 + a + p, j - 1 + b + q], where K sums
    the 3x3 taps that read the same source pixel.  Sums in fp32, rounded to
    weight.dtype once (plain sums, not a matmul that TF32 could round)."""
    folds = (((0,), (1, 2)), ((0, 1), (2,)))  # [p][a]: the 3x3 tap rows tap a sums
    wf = weight.float()
    k = torch.stack([torch.stack([torch.stack([torch.stack([
        wf[:, :, list(folds[p][a])][:, :, :, list(folds[q][b])].sum((2, 3))
        for b in (0, 1)]) for a in (0, 1)]) for q in (0, 1)]) for p in (0, 1)])
    return k.to(weight.dtype).contiguous()


def up2_phases_plain(
    x: torch.Tensor,
    phases: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
) -> torch.Tensor:
    """The up2 kernel's function from its phase weights [2, 2, 2, 2, Cout,
    Cin]: four fp32 2x2 convs on the zero-padded low-res input,
    interleaved, then bias and SiLU, one rounding."""
    b, h, w, _ = x.shape
    cout = phases.shape[4]
    xp = F.pad(_nchw_f32(x), (1, 1, 1, 1))
    out = torch.empty((b, cout, 2 * h, 2 * w), dtype=torch.float32, device=x.device)
    for p in (0, 1):
        for q in (0, 1):
            k = phases[p, q].float().permute(2, 3, 0, 1)  # [a, b, o, i] -> OIHW
            out[:, :, p::2, q::2] = F.conv2d(xp[:, :, p : p + h + 1, q : q + w + 1], k)
    out = _finish(out.permute(0, 2, 3, 1), bias, act)
    return out.to(x.dtype).contiguous()


def conv3x3_up2_plain(x, weight, bias=None, act=None) -> torch.Tensor:
    """Nearest-2x upsample then 3x3 SAME conv, as the kernel computes it."""
    return up2_phases_plain(x, make_phase_kernels(weight), bias, act)


def conv3x3_down2_plain(x, weight, bias=None, act=None, asymmetric: bool = False):
    """Stride-2 3x3 conv, fp32, padding (0, 1) or (1, 1), one rounding."""
    pad = (0, 1, 0, 1) if asymmetric else (1, 1, 1, 1)
    out = F.conv2d(F.pad(_nchw_f32(x), pad), weight.float(), stride=2).permute(0, 2, 3, 1)
    return _finish(out, bias, act).to(x.dtype).contiguous()


def conv3x3_down2_tiled_plain(x, weight, bias=None, act=None, asymmetric: bool = False,
                              poison_past_cin: bool = False):
    """The stride-2 kernel's schedule in plain PyTorch, for tests only: per
    output rectangle of ``plan_down2`` and per 64-channel chunk, the windows
    of the input's four parity planes gathered with zero fill, then nine taps,
    each a shifted rectangle of its plane's window, accumulated in fp32; then
    bias, SiLU and one rounding.  It differs from ``conv3x3_down2_plain`` only
    in the order of the sums.  ``poison_past_cin`` plants a fault: a chunk
    that runs past Cin reads NaN there instead of zeros, as a view that packs
    both column parities into its innermost dimension would read the
    neighbouring pixel."""
    b, h, w, cin = x.shape
    cout = weight.shape[0]
    pl = plan_down2(b, h, w, cin, cout, asymmetric)
    rh, rw = pl.rect
    ho, wo = h // 2, w // 2
    wf = weight.float()
    out = torch.zeros((b, ho, wo, cout), dtype=torch.float32, device=x.device)
    for bi in range(b):
        for y0, x0 in pl.rectangles(ho, wo):
            acc = torch.zeros((rh, rw, cout), dtype=torch.float32, device=x.device)
            for c0 in range(0, cin, CHUNK):
                c1 = min(cin, c0 + CHUNK)
                windows = {}
                for py, px, rows, cols, dy, dx in pl.planes:
                    plane = x[bi, py::2, px::2, c0:c1].float()  # [ho, wo, chunk]
                    ys, xs = y0 - dy, x0 - dx
                    ya, xa = max(0, ys), max(0, xs)
                    yb, xb = min(ho, ys + rows), min(wo, xs + cols)
                    win = torch.zeros((rows, cols, CHUNK), dtype=torch.float32, device=x.device)
                    if poison_past_cin:
                        win[:, :, c1 - c0:] = float("nan")
                    win[ya - ys:yb - ys, xa - xs:xb - xs, :c1 - c0] = plane[ya:yb, xa:xb]
                    windows[py, px] = win
                wchunk = torch.zeros((cout, CHUNK, 3, 3), dtype=torch.float32, device=x.device)
                wchunk[:, :c1 - c0] = wf[:, c0:c1]
                for ky in range(3):
                    for kx in range(3):
                        (py, ro), (px, co) = pl.tap(ky), pl.tap(kx)
                        a = windows[py, px][ro:ro + rh, co:co + rw]
                        acc += a @ wchunk[:, :, ky, kx].T
            out[bi, y0:y0 + rh, x0:x0 + rw] = acc[:ho - y0, :wo - x0]
    return _finish(out, bias, act).to(x.dtype).contiguous()


# ------------------------------------------------------------------ wrappers


def _check(name, x, weight):
    if x.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16:
        raise TypeError(f"{name} kernel takes bf16 tensors; got {x.dtype}, {weight.dtype}")
    if weight.device != x.device:
        raise ValueError(f"{name}: x and weight must be on one device")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be a contiguous, 16-byte aligned NHWC tensor")
    if not weight.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: weight must be in channels_last memory")


def _f32(t: Optional[torch.Tensor], shape, what: str, device) -> Optional[torch.Tensor]:
    if t is None:
        return None
    t = t.float().contiguous()
    if tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{what} must be {tuple(shape)} on {device}; got "
                         f"{tuple(t.shape)} on {t.device}")
    return t


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(symbol: str, name: str, out: torch.Tensor, *args) -> torch.Tensor:
    from fastedit_tpu_torch.ops.build import library

    fn = getattr(library("conv3x3"), symbol)
    with torch.cuda.device(out.device):
        err = fn(*args, torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1
    return out


def conv3x3_fused(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    prenorm: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    act: Optional[str] = None,
    skip: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused resnet conv: x [B, H, W, Cin], weight [Cout, Cin, 3, 3];
    ``bias`` [Cout] or per-batch [B, Cout]; ``prenorm`` fp32 (scale, shift)
    [B, Cin]; ``skip`` [B, H, W, Cout] added after bias and act."""
    if x.device.type == "cpu":
        return conv3x3_fused_plain(x, weight, bias, prenorm, act, skip)
    if act not in (None, "silu"):
        raise ValueError(f"unsupported activation {act!r}")
    _check("conv3x3_fused", x, weight)
    if not supports_fused(tuple(x.shape), tuple(weight.shape)):
        raise ValueError(f"conv3x3_fused does not take x {tuple(x.shape)}, "
                         f"weight {tuple(weight.shape)}")
    b, h, w, cin = x.shape
    cout = weight.shape[0]
    if bias is not None:
        bias = bias.float().reshape(-1, cout).contiguous()
        if bias.shape[0] not in (1, b) or bias.device != x.device:
            raise ValueError(f"conv3x3_fused: bias must be [{cout}] or [{b}, {cout}] "
                             f"on {x.device}; got {tuple(bias.shape)} on {bias.device}")
    scale = shift = None
    if prenorm is not None:
        scale = _f32(prenorm[0], (b, cin), "conv3x3_fused: scale", x.device)
        shift = _f32(prenorm[1], (b, cin), "conv3x3_fused: shift", x.device)
    if skip is not None and (skip.dtype != x.dtype or tuple(skip.shape) != (b, h, w, cout)
                             or not skip.is_contiguous() or skip.device != x.device):
        raise ValueError(f"conv3x3_fused: skip must be a contiguous {x.dtype} "
                         f"{(b, h, w, cout)} tensor on {x.device}")
    pl = plan_for(x, cout)
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    return _launch(
        "conv3x3_fused_bf16", "conv3x3_fused", out,
        x.data_ptr(), weight.data_ptr(), _ptr(bias), _ptr(scale), _ptr(shift), _ptr(skip),
        out.data_ptr(), b, h, w, cin, cout, int(act == "silu"),
        1 if bias is None else bias.shape[0], pl.bn, pl.grid,
    )


def conv3x3_up2(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
) -> torch.Tensor:
    """Nearest-2x upsample then 3x3 SAME conv in one kernel: x [B, H, W,
    Cin], weight [Cout, Cin, 3, 3] -> [B, 2H, 2W, Cout]."""
    if x.device.type == "cpu":
        return conv3x3_up2_plain(x, weight, bias, act)
    if act not in (None, "silu"):
        raise ValueError(f"unsupported activation {act!r}")
    _check("conv3x3_up2", x, weight)
    if not supports_up2(tuple(x.shape), tuple(weight.shape)):
        raise ValueError(f"conv3x3_up2 does not take x {tuple(x.shape)}, "
                         f"weight {tuple(weight.shape)}")
    b, h, w, cin = x.shape
    cout = weight.shape[0]
    bias = _f32(bias, (cout,), "conv3x3_up2: bias", x.device)
    phases = torch.empty((2, 2, 2, 2, cout, cin), dtype=x.dtype, device=x.device)
    out = torch.empty((b, 2 * h, 2 * w, cout), dtype=x.dtype, device=x.device)
    return _launch(
        "conv3x3_up2_bf16", "conv3x3_up2", out,
        x.data_ptr(), weight.data_ptr(), phases.data_ptr(), _ptr(bias), out.data_ptr(),
        b, h, w, cin, cout, int(act == "silu"),
    )


def conv3x3_down2(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
    asymmetric: bool = False,
) -> torch.Tensor:
    """Stride-2 3x3 conv: x [B, H, W, Cin] (H, W even), weight [Cout, Cin, 3,
    3] -> [B, H/2, W/2, Cout]; padding (1, 1), or (0, 1) with
    ``asymmetric`` (the VAE encoder's)."""
    if x.device.type == "cpu":
        return conv3x3_down2_plain(x, weight, bias, act, asymmetric)
    if act not in (None, "silu"):
        raise ValueError(f"unsupported activation {act!r}")
    _check("conv3x3_down2", x, weight)
    if not supports_down2(tuple(x.shape), tuple(weight.shape)):
        raise ValueError(f"conv3x3_down2 does not take x {tuple(x.shape)}, "
                         f"weight {tuple(weight.shape)}")
    b, h, w, cin = x.shape
    cout = weight.shape[0]
    bias = _f32(bias, (cout,), "conv3x3_down2: bias", x.device)
    pl = plan_down2_for(x, cout, asymmetric)
    out = torch.empty((b, h // 2, w // 2, cout), dtype=x.dtype, device=x.device)
    return _launch(
        "conv3x3_down2_bf16", "conv3x3_down2", out,
        x.data_ptr(), weight.data_ptr(), _ptr(bias), out.data_ptr(),
        b, h, w, cin, cout, int(act == "silu"), pl.pad, pl.bn, pl.grid,
    )
