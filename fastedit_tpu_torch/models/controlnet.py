"""ControlNet (Canny) for the SDXL family — UNet-encoder clone + zero convs.

Produces one residual per UNet skip connection plus a mid residual, each
scaled by ``conditioning_scale`` (a number, or a 0-dim fp32 tensor on the
model's device, which a CUDA graph reads at replay).  The conditioning image (Canny edges in
[0, 1], pixel resolution) is folded in through a strided conv tower whose
output is added to the latent stem; the denoise loop runs that tower once
per edit and passes its output with ``cond_pre_embedded=True``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from fastedit_tpu_torch.models.configs import ControlNetConfig
from fastedit_tpu_torch.models.resnet import Conv1x1, Conv3x3, StridedConv3x3
from fastedit_tpu_torch.models.unet import (
    ConditioningEmbedder,
    DownBlock,
    MidBlock,
    skip_channels,
)


class ControlNetConditioningEmbedding(nn.Module):
    """Pixel-space cond image -> latent-resolution feature via strided convs.
    The stride-2 convs pad (1,1) as torch's Conv2d(stride=2, padding=1)
    does, not (0,1) as Flax's SAME would."""

    def __init__(self, cond_channels: int, channels: Tuple[int, ...], out_channels: int):
        super().__init__()
        self.conv_in = Conv3x3(cond_channels, channels[0])
        blocks = []
        for i in range(len(channels) - 1):
            blocks.append(Conv3x3(channels[i], channels[i]))
            blocks.append(StridedConv3x3(channels[i], channels[i + 1]))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = Conv3x3(channels[-1], out_channels)

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.conv_in(cond))
        for block in self.blocks:
            x = F.silu(block(x))
        return self.conv_out(x)


class ControlNetModel(ConditioningEmbedder):
    """Returns (down_block_residuals, mid_residual) for UNet injection."""

    def __init__(self, config: ControlNetConfig):
        cfg = config.unet
        super().__init__(cfg)
        self.config = config
        chans = list(cfg.block_out_channels)
        n = len(chans)
        self.conv_in = Conv3x3(cfg.in_channels, chans[0])
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(
            config.conditioning_channels, config.conditioning_embedding_channels, chans[0]
        )
        self.down_blocks = nn.ModuleList()
        prev = chans[0]
        for i, ch in enumerate(chans):
            self.down_blocks.append(DownBlock(
                prev, ch, cfg.down_transformer_layers[i], cfg.num_attention_heads[i],
                i < n - 1, cfg,
            ))
            prev = ch
        self.mid_block = (
            MidBlock(chans[-1], cfg.mid_transformer_layers, cfg.num_attention_heads[-1], cfg)
            if cfg.mid_transformer_layers is not None else None
        )
        self.controlnet_down_blocks = nn.ModuleList(
            [Conv1x1(c, c) for c in skip_channels(cfg)]
        )
        self.controlnet_mid_block = Conv1x1(chans[-1], chans[-1])

    def forward(
        self,
        latents: torch.Tensor,
        timestep: torch.Tensor,
        encoder_hidden_states: torch.Tensor,
        text_embeds: torch.Tensor,
        time_ids: torch.Tensor,
        controlnet_cond: torch.Tensor,
        conditioning_scale=1.0,
        cond_pre_embedded: bool = False,
    ):
        dtype = self.conv_in.weight.dtype
        if timestep.dim() == 0:
            timestep = timestep.expand(latents.shape[0])
        temb = self.cond_embed(timestep, text_embeds, time_ids).to(dtype)
        context = encoder_hidden_states.to(dtype)

        x = self.conv_in(latents)
        if cond_pre_embedded:
            x = x + controlnet_cond.to(dtype)
        else:
            x = x + self.controlnet_cond_embedding(controlnet_cond.to(dtype))

        skips = [x]
        for block in self.down_blocks:
            x, res = block(x, temb, context)
            skips.extend(res)
        if self.mid_block is not None:
            x = self.mid_block(x, temb, context)

        scale = (conditioning_scale if torch.is_tensor(conditioning_scale)
                 else float(conditioning_scale))
        down_res = tuple(
            (conv(s).float() * scale).to(dtype)
            for conv, s in zip(self.controlnet_down_blocks, skips)
        )
        mid_res = (self.controlnet_mid_block(x).float() * scale).to(dtype)
        return down_res, mid_res
