"""AutoencoderKL — the SDXL VAE: encode pixels to latents, decode back.

The mid block's attention is one head of width C over all H*W positions
(seq 16384 at 1024² input), served by the flash kernel at D = 512.
Latent scaling (x0.13025) is applied by the pipeline stages.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from fastedit_tpu_torch import ops
from fastedit_tpu_torch.models.configs import VAEConfig
from fastedit_tpu_torch.models.layers import GroupNorm
from fastedit_tpu_torch.models.resnet import (
    Conv1x1,
    Conv3x3,
    Downsample2D,
    ResnetBlock2D,
    Upsample2D,
)


class VAEAttention(nn.Module):
    """Single-head full attention over HW with residual (diffusers'
    Attention with a group_norm, biased q/k/v)."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels), nn.Dropout(0.0)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        hs = self.group_norm(x).reshape(b, h * w, c)
        q = self.to_q(hs).view(b, h * w, 1, c)
        k = self.to_k(hs).view(b, h * w, 1, c)
        v = self.to_v(hs).view(b, h * w, 1, c)
        out = ops.attention(q, k, v).reshape(b, h * w, c)
        return self.to_out[0](out).reshape(b, h, w, c) + x


class VAEMidBlock(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(ch, ch, None, groups, 1e-6) for _ in range(2)]
        )
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _EncoderBlock(nn.Module):
    def __init__(self, in_ch, out_ch, layers, groups, add_downsample):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, None, groups, 1e-6)
            for j in range(layers)
        ])
        self.downsamplers = nn.ModuleList(
            [Downsample2D(out_ch, asymmetric_pad=True)] if add_downsample else []
        )

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        for d in self.downsamplers:
            x = d(x)
        return x


class _DecoderBlock(nn.Module):
    def __init__(self, in_ch, out_ch, layers, groups, add_upsample):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, None, groups, 1e-6)
            for j in range(layers)
        ])
        self.upsamplers = nn.ModuleList([Upsample2D(out_ch)] if add_upsample else [])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        for u in self.upsamplers:
            x = u(x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = list(cfg.block_out_channels)
        n = len(chans)
        self.conv_in = Conv3x3(cfg.in_channels, chans[0])
        self.down_blocks = nn.ModuleList([
            _EncoderBlock(chans[max(i - 1, 0)], ch, cfg.layers_per_block,
                          cfg.norm_groups, i < n - 1)
            for i, ch in enumerate(chans)
        ])
        self.mid_block = VAEMidBlock(chans[-1], cfg.norm_groups)
        self.conv_norm_out = GroupNorm(cfg.norm_groups, chans[-1], 1e-6, act="silu")
        self.conv_out = Conv3x3(chans[-1], 2 * cfg.latent_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(self.conv_norm_out(x))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        n = len(rev)
        self.conv_in = Conv3x3(cfg.latent_channels, rev[0])
        self.mid_block = VAEMidBlock(rev[0], cfg.norm_groups)
        self.up_blocks = nn.ModuleList([
            _DecoderBlock(rev[max(i - 1, 0)], ch, cfg.layers_per_block + 1,
                          cfg.norm_groups, i < n - 1)
            for i, ch in enumerate(rev)
        ])
        self.conv_norm_out = GroupNorm(cfg.norm_groups, rev[-1], 1e-6, act="silu")
        self.conv_out = Conv3x3(rev[-1], cfg.in_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(x))


class AutoencoderKL(nn.Module):
    """KL VAE with a diagonal-Gaussian posterior."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv1x1(2 * cfg.latent_channels, 2 * cfg.latent_channels)
        self.post_quant_conv = Conv1x1(cfg.latent_channels, cfg.latent_channels)

    def encode_moments(self, x: torch.Tensor):
        moments = self.quant_conv(self.encoder(x))
        return moments.chunk(2, dim=-1)

    @staticmethod
    def sample(mean: torch.Tensor, logvar: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """mean + std * eps with logvar clipped to [-30, 20]; ``eps`` is the
        caller's standard normal draw (broadcast over the batch if it has
        batch 1)."""
        logvar = logvar.float().clamp(-30.0, 20.0)
        std = torch.exp(0.5 * logvar)
        return (mean.float() + std * eps.float()).to(mean.dtype)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))
