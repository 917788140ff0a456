"""3xTF32 in plain PyTorch: the split the fp32 tensor-core kernels make, and
their arithmetic on it, for the tests and for ``chip_smoke.py``'s gate.

The stride-1, fused, upsample and stride-2 convs (``csrc/conv3x3_tf32x3.cu``)
and the 64- and 512-dim attention (``csrc/flash_attention_tf32x3.cu``) take every fp32 product
as three TF32 products on the tensor cores: with ``hi = tf32(x)`` rounded to nearest (ties
away from zero, ``cvt.rna.tf32.f32``) and ``lo = tf32(x - hi)``,
``a * b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi``.  The tensor cores read an fp32
word's top 19 bits and drop the rest (:func:`truncate_tf32`); a TF32 product
is exact in fp32.  Here the rounding and the truncation are bit operations on
an int32 view, so the emulation is exact on any device, and the products are
fp32 matmuls or convs of TF32 values (exact products, fp32 sums: TF32 must be
off on a card, where ``utils/precision.true_fp32`` holds it off).

``passes=1`` is single-pass TF32 (the lo products dropped): the planted fault
that an fp64 gate must tell from 3xTF32 (``chip_smoke.py``, the CPU tests).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

LOW_BITS = 13  # fp32 mantissa bits below TF32's 10
_MASK = -(1 << LOW_BITS)  # 0xFFFFE000 as an int32


def truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of fp32 ``x``: its low 13 bits dropped."""
    return (x.float().contiguous().view(torch.int32) & _MASK).view(torch.float32)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to the nearest TF32 value, ties away from zero
    (``cvt.rna.tf32.f32``): half of the dropped bits' weight added to the
    magnitude, then truncated.  Infinities and NaNs are not expected."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + (1 << (LOW_BITS - 1))) & _MASK).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): ``hi = tf32(x)`` and ``lo = tf32(x - hi)``, both rounded."""
    hi = round_tf32(x)
    return hi, round_tf32(x.float() - hi)


def _products(a: torch.Tensor, b: torch.Tensor, op, passes: int) -> torch.Tensor:
    """``op`` of the split operands: lo-hi, hi-lo and hi-hi (``passes=3``),
    or hi-hi alone (``passes=1``), summed in fp32 in the kernels' order."""
    if passes not in (1, 3):
        raise ValueError(f"3xTF32: passes must be 1 or 3, not {passes}")
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    if passes == 1:
        return op(a_hi, b_hi)
    return op(a_lo, b_hi) + op(a_hi, b_lo) + op(a_hi, b_hi)


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, act: Optional[str] = None,
                  passes: int = 3) -> torch.Tensor:
    """The SAME stride-1 conv of fp32 NHWC ``x`` and OIHW ``weight`` as the
    3xTF32 kernel takes its products (``passes=1``: single-pass TF32), then
    bias and SiLU in fp32."""
    xp = F.pad(x.float().permute(0, 3, 1, 2), (1, 1, 1, 1))
    return _finish(_products(xp, weight.float(), F.conv2d, passes), bias, act)


def conv3x3_fused_plain(x: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        prenorm: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
                        act: Optional[str] = None, skip: Optional[torch.Tensor] = None,
                        passes: int = 3) -> torch.Tensor:
    """The fused conv as the 3xTF32 kernel takes its products: the prologue
    silu(x * scale + shift) in fp32 first, then the split, the SAME stride-1
    conv of the products (``passes=1``: single-pass TF32), bias [Cout] or [B,
    Cout], SiLU and the skip in fp32."""
    xf = x.float()
    if prenorm is not None:
        xf = F.silu(xf * prenorm[0].float()[:, None, None, :]
                    + prenorm[1].float()[:, None, None, :])
    out = conv3x3_plain(xf, weight, bias, act, passes)
    return out if skip is None else out + skip.float()


def conv3x3_up2_plain(x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor] = None, act: Optional[str] = None,
                      passes: int = 3) -> torch.Tensor:
    """Nearest-2x upsample then 3x3 SAME conv as the 3xTF32 kernel takes its
    products: the phase weights folded in fp32 (``conv_fused.make_phase_kernels``)
    and split, four 2 x 2 convs of the split low-res input (``passes=1``:
    single-pass TF32), interleaved; then bias and SiLU in fp32."""
    from fastedit_tpu_torch.ops.conv_fused import make_phase_kernels

    phases = make_phase_kernels(weight.float())  # [p, q, a, b, Cout, Cin]
    b, h, w, _ = x.shape
    xp = F.pad(x.float().permute(0, 3, 1, 2), (1, 1, 1, 1))
    out = torch.empty((b, weight.shape[0], 2 * h, 2 * w), dtype=torch.float32, device=x.device)
    for p in (0, 1):
        for q in (0, 1):
            k = phases[p, q].permute(2, 3, 0, 1)  # [a, b, o, i] -> OIHW
            out[:, :, p::2, q::2] = _products(xp[:, :, p:p + h + 1, q:q + w + 1], k, F.conv2d,
                                              passes)
    return _finish(out, bias, act)


def conv3x3_down2_plain(x: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor] = None, act: Optional[str] = None,
                        asymmetric: bool = False, passes: int = 3) -> torch.Tensor:
    """The stride-2 conv of fp32 NHWC ``x`` and OIHW ``weight`` as the
    3xTF32 kernel takes its products (``passes=1``: single-pass TF32), then
    bias and SiLU in fp32."""
    pad = (0, 1, 0, 1) if asymmetric else (1, 1, 1, 1)
    xp = F.pad(x.float().permute(0, 3, 1, 2), pad)
    return _finish(_products(xp, weight.float(), lambda a, b: F.conv2d(a, b, stride=2), passes),
                   bias, act)


def _finish(out: torch.Tensor, bias: Optional[torch.Tensor], act: Optional[str]) -> torch.Tensor:
    """NCHW conv sums -> NHWC, then bias and SiLU in fp32."""
    out = out.permute(0, 2, 3, 1)
    if bias is not None:
        b = bias.float()
        out = out + (b[:, None, None, :] if b.dim() == 2 else b)
    if act == "silu":
        out = F.silu(out)
    elif act is not None:
        raise ValueError(f"unsupported activation {act!r}")
    return out.contiguous()


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None, passes: int = 3) -> torch.Tensor:
    """softmax(Q K^T * scale) V over BSHD fp32 tensors with both products
    taken as the 3xTF32 kernel takes them (``passes=1``: single-pass TF32):
    the scores in fp32 from split Q and K, the softmax in fp32, P split
    again for P V."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    qt, kt, vt = (t.float().transpose(1, 2) for t in (q, k, v))  # [B, H, S, D]
    s = _products(qt, kt, lambda a, b: a @ b.transpose(-1, -2), passes)
    p = torch.softmax(s * scale, dim=-1)
    return _products(p, vt, torch.matmul, passes).transpose(1, 2).contiguous()
