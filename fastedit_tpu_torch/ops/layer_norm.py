"""LayerNorm over the last dim: the CUDA kernel's wrapper, its gate and its
plain version.

The JAX package has no Pallas kernel here: its ``LayerNorm``
(``fastedit_tpu/models/layers.py``) is plain jnp, which XLA fuses into one
pass.  Eager PyTorch runs the same math as about ten kernels over fp32
copies (:func:`layer_norm_plain`), so on the card a call is one launch of
``csrc/layer_norm.cu`` instead: a warp or a few a row (as many as leave a
thread three 16-byte vectors), the row held in registers, read once and
written once, fp32 two-pass statistics and affine, one rounding to x's
dtype.  It serves every LayerNorm of the port (the UNet's and the
ControlNet's transformer blocks, both CLIP text towers, the CLIP vision tower
and DINO), bf16 and fp32 (the quality mode; the ``_f32`` C entry, with a
launch counter of its own), and adapts to the row width C it is given.

:func:`layer_norm` is the dispatching entry the models call.  Inside the
gate (:func:`supports`, asked through ``flags.takes``: every stage's plan
has the kernel) it takes :func:`fused_layer_norm`, or the plain version
under ``flags.override(plain_versions=True)``; outside it the plain version,
counted as ``layer_norm.plain_on_card`` (``utils/profiling``) when x is on
the card.
"""

from __future__ import annotations

import torch

from fastedit_tpu_torch.ops import flags
from fastedit_tpu_torch.ops.conv3x3 import KERNEL_DTYPES, check_dtypes
from fastedit_tpu_torch.utils import profiling

# Launches since the last reset (chip_smoke.py resets them), bf16 and fp32.
launches = 0
launches_f32 = 0

MAX_CHANNELS = 2048  # csrc/layer_norm.cu holds the same
CHANNEL_MULTIPLE = 8  # whole 16-byte vectors in bf16, and an even count of them in fp32


def supports(c: int, dtype: torch.dtype = torch.bfloat16) -> bool:
    """Rows of ``c`` values of ``dtype`` are the kernel's.  The same widths
    in bf16 and fp32 (as every gate of the port, :mod:`.flags`)."""
    return dtype in KERNEL_DTYPES and 0 < c <= MAX_CHANNELS and c % CHANNEL_MULTIPLE == 0


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics (two-pass variance) and fp32 affine,
    cast back to x's dtype: the kernel's plain version, and the op outside
    its gate."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def _check(x, weight, bias):
    check_dtypes("layer_norm", x)
    c = x.shape[-1]
    if not supports(c, x.dtype):
        raise ValueError(f"layer_norm kernel does not take rows of {c} values")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("layer_norm: x must be a contiguous, 16-byte aligned tensor")
    weight, bias = weight.float().contiguous(), bias.float().contiguous()
    if (weight.shape != (c,) or bias.shape != (c,) or weight.device != x.device
            or bias.device != x.device):
        raise ValueError(f"layer_norm: weight and bias must be [{c}] on {x.device}")
    if weight.data_ptr() % 16 or bias.data_ptr() % 16:
        raise ValueError("layer_norm: weight and bias must be 16-byte aligned")
    return weight, bias


def fused_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """x [..., C] bf16 or fp32, weight/bias [C] -> LayerNorm(x) in x's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (once) or raises."""
    check_dtypes("layer_norm", x)
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    weight, bias = _check(x, weight, bias)
    from fastedit_tpu_torch.ops.build import library

    out = torch.empty_like(x)
    name = "layer_norm_f32" if x.dtype == torch.float32 else "layer_norm_bf16"
    with torch.cuda.device(x.device):
        err = getattr(library("layer_norm"), name)(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            x.numel() // x.shape[-1], x.shape[-1], float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    global launches, launches_f32
    if x.dtype == torch.float32:
        launches_f32 += 1
    else:
        launches += 1
    return out


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Dispatching LayerNorm entry point used by all models.  On the card a
    strided or misaligned x inside the gate (the CLIP vision tower's class
    token, ``x[:, 0]``) is copied first, as the kernel takes whole aligned
    rows."""
    if flags.takes("layer_norm", x.shape[-1], x.dtype):
        if x.is_cuda and (not x.is_contiguous() or x.data_ptr() % 16):
            x = x.clone(memory_format=torch.contiguous_format)
        return flags.kernel_or_plain(fused_layer_norm, layer_norm_plain)(x, weight, bias, eps)
    if x.is_cuda:
        profiling.count("layer_norm.plain_on_card")
    return layer_norm_plain(x, weight, bias, eps)
