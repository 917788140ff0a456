"""UNet2DConditionModel — SDXL / SSD-1B conditional UNet, config-driven.

One class covers the SDXL and the SSD-1B topologies through
``UNetConfig``'s per-layer transformer depths (SSD-1B has no mid block and
asymmetric up depths).  NHWC activations; parameter names follow
diffusers, so ``attentions`` is a dict keyed by the resnet index it follows
(a depth-0 layer has none).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from fastedit_tpu_torch.models.configs import UNetConfig
from fastedit_tpu_torch.models.layers import (
    GroupNorm,
    TimestepEmbedding,
    Transformer2DModel,
    timestep_embedding,
)
from fastedit_tpu_torch.models.resnet import (
    Conv3x3,
    Downsample2D,
    ResnetBlock2D,
    Upsample2D,
)


def _attentions(depths, channels, heads, head_dim, context_dim) -> nn.ModuleDict:
    return nn.ModuleDict({
        str(j): Transformer2DModel(channels, heads, head_dim, d, context_dim)
        for j, d in enumerate(depths) if d > 0
    })


class DownBlock(nn.Module):
    """Resnets (+ per-layer transformers) + optional downsample; returns the
    new hidden state and the skip residuals it appends."""

    def __init__(self, in_ch, out_ch, depths, heads, add_downsample, cfg: UNetConfig):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, cfg.time_embed_dim,
                          cfg.norm_groups, cfg.norm_eps)
            for j in range(len(depths))
        ])
        self.attentions = _attentions(
            depths, out_ch, heads, out_ch // heads, cfg.cross_attention_dim
        )
        self.downsamplers = nn.ModuleList(
            [Downsample2D(out_ch)] if add_downsample else []
        )

    def forward(self, x, temb, context):
        residuals = []
        for j, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if str(j) in self.attentions:
                x = self.attentions[str(j)](x, context)
            residuals.append(x)
        for down in self.downsamplers:
            x = down(x)
            residuals.append(x)
        return x, residuals


class MidBlock(nn.Module):
    """resnet -> [transformer ->] resnet."""

    def __init__(self, ch, depth, heads, cfg: UNetConfig):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(ch, ch, cfg.time_embed_dim, cfg.norm_groups, cfg.norm_eps)
            for _ in range(2)
        ])
        self.attentions = _attentions(
            (depth,), ch, heads, ch // heads, cfg.cross_attention_dim
        )

    def forward(self, x, temb, context):
        x = self.resnets[0](x, temb)
        if "0" in self.attentions:
            x = self.attentions["0"](x, context)
        return self.resnets[1](x, temb)


class UpBlock(nn.Module):
    """Skip-concat resnets (+ per-layer transformers) + optional upsample."""

    def __init__(self, prev_ch, out_ch, skip_chs, depths, heads, add_upsample,
                 cfg: UNetConfig):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D((prev_ch if j == 0 else out_ch) + skip_chs[j], out_ch,
                          cfg.time_embed_dim, cfg.norm_groups, cfg.norm_eps)
            for j in range(len(depths))
        ])
        self.attentions = _attentions(
            depths, out_ch, heads, out_ch // heads, cfg.cross_attention_dim
        )
        self.upsamplers = nn.ModuleList([Upsample2D(out_ch)] if add_upsample else [])

    def forward(self, x, skips: Sequence[torch.Tensor], temb, context):
        for j, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips[j]], dim=-1), temb)
            if str(j) in self.attentions:
                x = self.attentions[str(j)](x, context)
        for up in self.upsamplers:
            x = up(x)
        return x


def skip_channels(cfg: UNetConfig) -> list[int]:
    """Channels of the down path's skip residuals, in push order."""
    chans = list(cfg.block_out_channels)
    out = [chans[0]]
    for i, ch in enumerate(chans):
        out += [ch] * cfg.layers_per_block
        if i < len(chans) - 1:
            out.append(ch)
    return out


class ConditioningEmbedder(nn.Module):
    """Time + added-condition embeddings shared by UNet and ControlNet:
    emb = MLP(sin(t)) + MLP(concat(pooled_text_emb, sin(time_ids)))."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        self.time_embedding = TimestepEmbedding(cfg.block_out_channels[0],
                                                cfg.time_embed_dim)
        self.add_embedding = TimestepEmbedding(
            cfg.projection_class_embeddings_input_dim, cfg.time_embed_dim
        )

    def cond_embed(self, timestep, text_embeds, time_ids) -> torch.Tensor:
        cfg = self.cfg
        emb = self.time_embedding(timestep_embedding(timestep, cfg.block_out_channels[0]))
        b, n_ids = time_ids.shape
        ids_emb = timestep_embedding(
            time_ids.reshape(-1), cfg.addition_time_embed_dim
        ).reshape(b, n_ids * cfg.addition_time_embed_dim)
        add_in = torch.cat([text_embeds.float(), ids_emb], dim=-1)
        if add_in.shape[-1] != cfg.projection_class_embeddings_input_dim:
            raise ValueError(
                f"added-cond input dim {add_in.shape[-1]} != configured "
                f"{cfg.projection_class_embeddings_input_dim}"
            )
        return emb + self.add_embedding(add_in)


class UNet2DConditionModel(ConditioningEmbedder):
    """The SDXL-family denoiser.  NHWC latents in, epsilon out."""

    def __init__(self, cfg: UNetConfig):
        super().__init__(cfg)
        chans = list(cfg.block_out_channels)
        n = len(chans)
        self.conv_in = Conv3x3(cfg.in_channels, chans[0])
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
        skips = skip_channels(cfg)
        self.up_blocks = nn.ModuleList()
        prev = chans[-1]
        for i, ch in enumerate(reversed(chans)):
            L = cfg.layers_per_block + 1
            block_skips = skips[-L:][::-1]
            del skips[-L:]
            self.up_blocks.append(UpBlock(
                prev, ch, block_skips, cfg.up_transformer_layers[i],
                cfg.num_attention_heads[n - 1 - i], i < n - 1, cfg,
            ))
            prev = ch
        self.conv_norm_out = GroupNorm(cfg.norm_groups, chans[0], cfg.norm_eps, act="silu")
        self.conv_out = Conv3x3(chans[0], cfg.out_channels)

    def forward(
        self,
        latents: torch.Tensor,  # [B, h, w, in_channels]
        timestep: torch.Tensor,  # [B]
        encoder_hidden_states: torch.Tensor,  # [B, S_text, cross_attention_dim]
        text_embeds: torch.Tensor,  # [B, pooled_dim]
        time_ids: torch.Tensor,  # [B, 6]
        down_block_additional_residuals: Optional[Sequence[torch.Tensor]] = None,
        mid_block_additional_residual: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        dtype = self.conv_in.weight.dtype
        if timestep.dim() == 0:
            timestep = timestep.expand(latents.shape[0])
        temb = self.cond_embed(timestep, text_embeds, time_ids).to(dtype)
        context = encoder_hidden_states.to(dtype)
        x = self.conv_in(latents)

        skips = [x]
        for block in self.down_blocks:
            x, res = block(x, temb, context)
            skips.extend(res)

        if down_block_additional_residuals is not None:
            if len(down_block_additional_residuals) != len(skips):
                raise ValueError(
                    f"got {len(down_block_additional_residuals)} controlnet "
                    f"residuals for {len(skips)} skips"
                )
            skips = [s + r.to(s.dtype) for s, r in zip(skips, down_block_additional_residuals)]

        if self.mid_block is not None:
            x = self.mid_block(x, temb, context)
        if mid_block_additional_residual is not None:
            x = x + mid_block_additional_residual.to(x.dtype)

        L = self.cfg.layers_per_block + 1
        for block in self.up_blocks:
            block_skips = skips[-L:][::-1]
            del skips[-L:]
            x = block(x, block_skips, temb, context)
        return self.conv_out(self.conv_norm_out(x))
