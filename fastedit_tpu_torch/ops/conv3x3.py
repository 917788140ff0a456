"""3x3 SAME stride-1 conv, NHWC: CUDA kernel wrapper and its plain version.

The kernel (``csrc/conv3x3.cu``) replaces the TPU kernel
``fastedit_tpu/ops/conv3x3.py`` (``conv3x3`` -> ``_conv3x3_call``): an
implicit GEMM over the 9 taps on the tensor cores, fp32 accumulation, and
an fp32 epilogue (bias, then optional SiLU, then one rounding to bf16).

Layouts: ``x`` is NHWC ``[B, H, W, Cin]``; ``weight`` is PyTorch's OIHW
``[Cout, Cin, 3, 3]`` and the kernel reads it in channels_last memory
(OHWI), so both GEMM operands are contiguous along Cin.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# Launches of the CUDA kernel since the last reset (chip_smoke.py resets it).
launches = 0


def supports(x_shape, w_shape) -> bool:
    """The gate: the same calls reach the kernel as reach the Pallas conv in
    the JAX package's bf16 configuration (3x3, Cin >= 64).  The TPU kernel's
    VMEM tile budget admits every such call on the main path and does not
    carry over.  Cin must also be a multiple of 8 (16-byte rows); every
    model the repo supports satisfies it."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    cin = x_shape[-1]
    cout, wcin, kh, kw = w_shape
    return (kh, kw) == (3, 3) and wcin == cin and cin >= 64 and cin % 8 == 0


def conv3x3_plain(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 conv on an upcast, fp32
    bias and SiLU, one rounding to x.dtype.  TF32 must be off for this to be
    an fp32 reference on a card (chip_smoke.py sets it)."""
    out = F.conv2d(
        x.permute(0, 3, 1, 2).float(), weight.float(), padding=1
    ).permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias.float()
    if act == "silu":
        out = F.silu(out)
    elif act is not None:
        raise ValueError(f"unsupported activation {act!r}")
    return out.to(x.dtype).contiguous()


def _check(x, weight, bias):
    if x.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16:
        raise TypeError(
            f"conv3x3 kernel takes bf16 tensors; got {x.dtype}, {weight.dtype} "
            "(fp32 quality mode is a later slice)"
        )
    if weight.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError("conv3x3: x, weight and bias must be on one device")
    if not supports(tuple(x.shape), tuple(weight.shape)):
        raise ValueError(
            f"conv3x3 kernel does not take x {tuple(x.shape)}, "
            f"weight {tuple(weight.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError("conv3x3: x must be a contiguous NHWC tensor")
    if not weight.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv3x3: weight must be in channels_last memory")
    if bias is not None and (bias.dtype != torch.float32 or not bias.is_contiguous()):
        raise ValueError("conv3x3: bias must be a contiguous fp32 vector")
    if x.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError("conv3x3: x and weight must be 16-byte aligned")


def conv3x3(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
) -> torch.Tensor:
    """3x3 SAME conv: x [B, H, W, Cin] bf16, weight [Cout, Cin, 3, 3] bf16 in
    channels_last memory, bias [Cout] -> [B, H, W, Cout] bf16.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias, act)
    if act not in (None, "silu"):
        raise ValueError(f"unsupported activation {act!r}")
    bias = None if bias is None else bias.float().contiguous()
    _check(x, weight, bias)
    from fastedit_tpu_torch.ops.build import library

    fn = library("conv3x3").conv3x3_bf16
    b, h, w, cin = x.shape
    cout = weight.shape[0]
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), weight.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            b, h, w, cin, cout, int(act == "silu"), stream,
        )
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out
