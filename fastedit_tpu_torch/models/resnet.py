"""ResNet blocks and resampling layers (NHWC) for UNet / ControlNet / VAE.

The conv modules dispatch as the JAX package's do (``models/resnet.py``
there), on the kernel flags of the stage they run in (``ops/flags.py``):
whole resnet blocks through the fused conv kernel, upsamplers through the
up2 kernel, downsamplers through the stride-2 kernel, each where its flag
is on and its gate admits the call, and op by op with the same math
otherwise.  Convs subclass ``nn.Conv2d`` so their parameters keep
PyTorch's names and OIHW shapes; their ``forward`` takes and returns NHWC
tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from fastedit_tpu_torch.models.layers import GroupNorm
from fastedit_tpu_torch.ops import conv_fused, flags
from fastedit_tpu_torch.ops.conv import conv3x3_same


class Conv3x3(nn.Conv2d):
    """3x3 stride-1 SAME conv dispatched through ``ops.conv.conv3x3_same``
    (the conv kernel for Cin >= 64 where the context turns it on).

    Optional fused-resnet operands (``ops/conv_fused.conv3x3_fused``; each
    falls back to the same math op by op where the fused kernel is off or
    its gate refuses the call):

    * ``prenorm``: fp32 ``(scale, shift)`` [B, Cin]; the input is mapped
      through ``silu(x * scale + shift)`` before the taps (GroupNorm + SiLU
      with the statistics precomputed, ``GroupNorm(scale_shift=True)``).
    * ``extra_bias``: [B, Cout] per-batch add (the time embedding).
    * ``skip``: [B, H, W, Cout] residual added after the bias.
    * ``up2``: nearest-2x upsample before the conv (``conv3x3_up2``: no
      materialised 4x tensor).
    """

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, padding=1)

    def forward(
        self,
        x: torch.Tensor,
        prenorm: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
        extra_bias: Optional[torch.Tensor] = None,
        skip: Optional[torch.Tensor] = None,
        up2: bool = False,
    ) -> torch.Tensor:
        dtype = self.weight.dtype
        x = x.to(dtype).contiguous()
        w = self.weight.contiguous(memory_format=torch.channels_last)
        shapes = (tuple(x.shape), tuple(w.shape))

        if up2:
            assert prenorm is None and extra_bias is None and skip is None
            if flags.use_fused_up2() and conv_fused.supports_up2(*shapes):
                fn = flags.kernel_or_plain(conv_fused.conv3x3_up2, conv_fused.conv3x3_up2_plain)
                return fn(x, w, bias=self.bias)
            x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            return conv3x3_same(x, w, bias=self.bias)

        if prenorm is None and extra_bias is None and skip is None:
            return conv3x3_same(x, w, bias=self.bias)

        bias_eff = self.bias
        if extra_bias is not None:  # [B, Cout], summed in fp32
            bias_eff = self.bias.float()[None, :] + extra_bias.float()
        if flags.use_fused_resnet() and conv_fused.supports_fused(*shapes):
            fn = flags.kernel_or_plain(conv_fused.conv3x3_fused, conv_fused.conv3x3_fused_plain)
            return fn(x, w, bias=bias_eff, prenorm=prenorm,
                      skip=None if skip is None else skip.to(dtype).contiguous())
        # Unfused fallback: the same math as the kernel, op by op.
        if prenorm is not None:
            x = conv_fused.prologue_plain(x, *prenorm)
        out = conv3x3_same(x, w)
        out = out + (bias_eff[:, None, None, :] if bias_eff.dim() == 2 else bias_eff).to(dtype)
        if skip is not None:
            out = out + skip.to(dtype)
        return out.to(dtype)


class Conv1x1(nn.Conv2d):
    """1x1 conv as a matmul over the channel dim."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.view(self.out_channels, self.in_channels)
        return F.linear(x.to(w.dtype), w, self.bias)


class StridedConv3x3(nn.Conv2d):
    """Stride-2 3x3 conv with torch's (1,1) padding, or the VAE encoder's
    asymmetric (0,1) padding: the stride-2 kernel (``conv3x3_down2``) where
    ``flags.use_fused_down2()`` is on and its gate admits the call,
    PyTorch's strided conv otherwise."""

    def __init__(self, in_channels: int, out_channels: int, asymmetric: bool = False):
        super().__init__(in_channels, out_channels, 3, stride=2,
                         padding=0 if asymmetric else 1)
        self.asymmetric = asymmetric

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype).contiguous()
        w = self.weight.contiguous(memory_format=torch.channels_last)
        if flags.use_fused_down2() and conv_fused.supports_down2(tuple(x.shape), tuple(w.shape)):
            fn = flags.kernel_or_plain(conv_fused.conv3x3_down2, conv_fused.conv3x3_down2_plain)
            return fn(x, w, bias=self.bias, asymmetric=self.asymmetric)
        x = x.permute(0, 3, 1, 2)
        if self.asymmetric:
            x = F.pad(x, (0, 1, 0, 1))
        out = F.conv2d(x, self.weight, stride=2, padding=self.padding)
        out = out + self.bias.to(out.dtype)[:, None, None]
        return out.permute(0, 2, 3, 1).contiguous()


class ResnetBlock2D(nn.Module):
    """GN+SiLU -> conv3x3 -> (+time emb) -> GN+SiLU -> conv3x3 -> +shortcut.

    Where ``flags.use_fused_resnet()`` is on and the fused conv's gate admits
    both convs, the whole block runs as two fused convs: the GroupNorm
    statistics are plain reductions over the raw tensors, and the
    normalise + SiLU map, the time-embedding bias and the residual add ride
    inside the convs."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps=eps, act="silu")
        self.conv1 = Conv3x3(in_channels, out_channels)
        if temb_channels is not None:
            self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm(groups, out_channels, eps=eps, act="silu")
        self.conv2 = Conv3x3(out_channels, out_channels)
        self.conv_shortcut = (
            Conv1x1(in_channels, out_channels) if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None):
        t = None if temb is None else self.time_emb_proj(F.silu(temb))
        out_shape = (*x.shape[:-1], self.conv2.out_channels)
        if (flags.use_fused_resnet()
                and conv_fused.supports_fused(tuple(x.shape), tuple(self.conv1.weight.shape))
                and conv_fused.supports_fused(out_shape, tuple(self.conv2.weight.shape))):
            shortcut = x if self.conv_shortcut is None else self.conv_shortcut(x)
            h = self.conv1(x, prenorm=self.norm1(x, scale_shift=True), extra_bias=t)
            return self.conv2(h, prenorm=self.norm2(h, scale_shift=True), skip=shortcut)

        h = self.conv1(self.norm1(x))
        if t is not None:
            h = h + t[:, None, None, :]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """Strided conv downsample; the VAE encoder pads (0,1)."""

    def __init__(self, channels: int, asymmetric_pad: bool = False):
        super().__init__()
        self.conv = StridedConv3x3(channels, channels, asymmetric=asymmetric_pad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest x2 then conv3x3: the up2 kernel where the context turns it
    on, the exact repeat and the plain conv dispatch otherwise."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv3x3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, up2=True)
