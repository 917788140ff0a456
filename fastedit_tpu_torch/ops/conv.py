"""Dispatching 3x3 SAME stride-1 conv (NHWC).

Where the stage's plan has the conv kernel (``flags.takes``: the denoise
loop and the VAE decoder), calls inside the kernel's gate
(``conv3x3.supports``: Cin >= 64) go to the conv3x3 wrapper, which launches
the CUDA kernel on a card and runs the plain version on the CPU.  Calls
outside the gate (``conv_in`` with 4 channels, the ControlNet conditioning
stem) and every call whose stage's plan lacks the kernel (the VAE encoder)
run PyTorch's conv (cuDNN on the card), as the JAX package sends them to XLA.
``flags.override(plain_versions=True)`` selects the kernel's plain version
in the kernel's place, for comparisons.  In fp32 on the card the kernel takes
the weight's TF32 hi and lo copies, which the caller's ``split`` gives (the
conv modules split once per weight version, ``models/resnet.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from fastedit_tpu_torch.ops import conv3x3 as k
from fastedit_tpu_torch.ops import flags


def conv3x3_same(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
    split: Optional[Callable[[], tuple[torch.Tensor, torch.Tensor]]] = None,
) -> torch.Tensor:
    """NHWC x [B,H,W,Cin] * OIHW weight [Cout,Cin,3,3] + bias (+ SiLU).
    ``split`` gives ``conv_fused.split_tf32(weight)``; it is called only for
    an fp32 call that reaches the kernel on the card."""
    if flags.takes("conv3x3", tuple(x.shape), tuple(weight.shape)):
        def kernel(x, weight, bias=None, act=None):
            on_tf32x3 = split is not None and x.is_cuda and x.dtype == torch.float32
            return k.conv3x3(x, weight, bias, act, w_split=split() if on_tf32x3 else None)

        return flags.kernel_or_plain(kernel, k.conv3x3_plain)(x, weight, bias=bias, act=act)

    out = F.conv2d(x.permute(0, 3, 1, 2), weight, padding=1).permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias.to(out.dtype)
    if act == "silu":
        out = F.silu(out)
    elif act is not None:
        raise ValueError(f"unsupported activation {act!r}")
    return out.to(x.dtype).contiguous()
