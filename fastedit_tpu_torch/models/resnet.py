"""ResNet blocks and resampling layers (NHWC) for UNet / ControlNet / VAE.

This slice runs the unfused forms: resnet blocks op by op, upsamplers that
materialise the nearest-2x tensor before a 3x3 conv, downsamplers as plain
strided convs.  The fused conv kernels (resnet, up2, down2) are later
slices.  Convs subclass ``nn.Conv2d`` so their parameters keep PyTorch's
names and OIHW shapes; their ``forward`` takes and returns NHWC tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from fastedit_tpu_torch.models.layers import GroupNorm
from fastedit_tpu_torch.ops.conv import conv3x3_same


class Conv3x3(nn.Conv2d):
    """3x3 stride-1 SAME conv dispatched through ``ops.conv.conv3x3_same``
    (the CUDA kernel for Cin >= 64)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor, up2: bool = False) -> torch.Tensor:
        x = x.to(self.weight.dtype)
        if up2:  # nearest-2x, materialised (the fused up2 kernel is later)
            x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return conv3x3_same(
            x.contiguous(),
            self.weight.contiguous(memory_format=torch.channels_last),
            bias=self.bias,
        )


class Conv1x1(nn.Conv2d):
    """1x1 conv as a matmul over the channel dim."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.view(self.out_channels, self.in_channels)
        return F.linear(x.to(w.dtype), w, self.bias)


class StridedConv3x3(nn.Conv2d):
    """Stride-2 3x3 conv with torch's (1,1) padding, or the VAE encoder's
    asymmetric (0,1) padding."""

    def __init__(self, in_channels: int, out_channels: int, asymmetric: bool = False):
        super().__init__(in_channels, out_channels, 3, stride=2,
                         padding=0 if asymmetric else 1)
        self.asymmetric = asymmetric

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype).permute(0, 3, 1, 2)
        if self.asymmetric:
            x = F.pad(x, (0, 1, 0, 1))
        out = F.conv2d(x, self.weight, stride=2, padding=self.padding)
        out = out + self.bias.to(out.dtype)[:, None, None]
        return out.permute(0, 2, 3, 1).contiguous()


class ResnetBlock2D(nn.Module):
    """GN+SiLU -> conv3x3 -> (+time emb) -> GN+SiLU -> conv3x3 -> +shortcut."""

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
        h = self.conv1(self.norm1(x))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
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
    """Nearest x2 (exact repeat) then conv3x3."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv3x3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, up2=True)
