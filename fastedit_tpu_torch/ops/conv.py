"""Dispatching 3x3 SAME stride-1 conv (NHWC).

Where the context's conv flag is on (``flags.use_cuda_conv``: the denoise
loop and the VAE decoder by default), calls inside the kernel's gate
(``conv3x3.supports``: Cin >= 64) go to the conv3x3 wrapper, which launches
the CUDA kernel on a card and runs the plain version on the CPU.  Calls
outside the gate (``conv_in`` with 4 channels, the ControlNet conditioning
stem) and every call where the flag is off (the VAE encoder by default) run
PyTorch's conv (cuDNN on the card), as the JAX package sends them to XLA.
``flags.override(plain_versions=True)`` selects the kernel's plain version
in the kernel's place, for comparisons.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from fastedit_tpu_torch.ops import conv3x3 as k
from fastedit_tpu_torch.ops import flags


def conv3x3_same(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
) -> torch.Tensor:
    """NHWC x [B,H,W,Cin] * OIHW weight [Cout,Cin,3,3] + bias (+ SiLU)."""
    if flags.use_cuda_conv() and k.supports(tuple(x.shape), tuple(weight.shape)):
        return flags.kernel_or_plain(k.conv3x3, k.conv3x3_plain)(x, weight, bias=bias, act=act)

    out = F.conv2d(x.permute(0, 3, 1, 2), weight, padding=1).permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias.to(out.dtype)
    if act == "silu":
        out = F.silu(out)
    elif act is not None:
        raise ValueError(f"unsupported activation {act!r}")
    return out.to(x.dtype).contiguous()
