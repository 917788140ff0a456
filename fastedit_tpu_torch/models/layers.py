"""Core NHWC building blocks shared by UNet / ControlNet / VAE.

Modules carry diffusers state-dict names (``to_q``, ``to_out.0``,
``ff.net.0.proj``, ``time_emb_proj`` ...), so a diffusers checkpoint or the
JAX package's converted parameters (``tools/from_jax.py``) load with
``load_state_dict``.  Activations are NHWC as in the JAX package; compute
runs in the model dtype (bf16 on the card) with fp32 normalisation
statistics and fp32 softmax.  Norm parameters stay fp32 (:func:`cast_model`),
as the JAX package keeps them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from fastedit_tpu_torch import ops
from fastedit_tpu_torch.ops.groupnorm import group_norm_scale_shift


def timestep_embedding(
    t: torch.Tensor,
    dim: int,
    *,
    max_period: float = 10000.0,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
) -> torch.Tensor:
    """Sinusoidal timestep embeddings, fp32. t: [B] -> [B, dim]."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device)
        / (half - downscale_freq_shift)
    )
    args = t.float()[:, None] * freqs[None, :]
    if flip_sin_to_cos:
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    else:
        emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """Two-layer SiLU MLP lifting a sinusoidal embedding to the time channel."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, out_dim)
        self.linear_2 = nn.Linear(out_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.linear_1(x.to(self.linear_1.weight.dtype))
        return self.linear_2(F.silu(x))


class GroupNorm(nn.Module):
    """Parameter holder over ``ops.group_norm`` (NHWC, fp32 statistics)."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5,
                 act: Optional[str] = None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.act = act
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, scale_shift: bool = False):
        """GroupNorm(x) (+ act); with ``scale_shift``, the fp32 ``(scale,
        shift)`` [B, C] that fold the statistics with the affine, for the
        fused resnet conv's prologue, which applies SiLU unconditionally."""
        if scale_shift:
            assert self.act == "silu", (
                "scale_shift prologue consumers hardcode SiLU; "
                f"this GroupNorm has act={self.act!r}"
            )
            return group_norm_scale_shift(
                x, self.weight, self.bias, num_groups=self.num_groups, eps=self.eps
            )
        return ops.group_norm(
            x, self.weight, self.bias, num_groups=self.num_groups, eps=self.eps,
            act=self.act,
        )


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics, output cast back to the input dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        out = (xf - mean) * torch.rsqrt(var + self.eps)
        return (out * self.weight.float() + self.bias.float()).to(x.dtype)


def cast_model(model: nn.Module, device, dtype) -> nn.Module:
    """Move ``model`` to ``device`` in ``dtype`` with 4-D conv weights in
    channels_last memory (the layout the conv kernel reads), keeping norm
    parameters in fp32."""
    model.to(device=device, dtype=dtype, memory_format=torch.channels_last)
    for m in model.modules():
        if isinstance(m, (GroupNorm, LayerNorm)):
            m.float()
    return model


class Attention(nn.Module):
    """Multi-head attention (self or cross) over [B, S, C] sequences."""

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None, qkv_bias: bool = False):
        super().__init__()
        inner = heads * head_dim
        kv_dim = context_dim or query_dim
        self.heads = heads
        self.head_dim = head_dim
        self.to_q = nn.Linear(query_dim, inner, bias=qkv_bias)
        self.to_k = nn.Linear(kv_dim, inner, bias=qkv_bias)
        self.to_v = nn.Linear(kv_dim, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim), nn.Dropout(0.0)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None):
        ctx = x if context is None else context
        b, sq, _ = x.shape
        skv = ctx.shape[1]
        q = self.to_q(x).view(b, sq, self.heads, self.head_dim)
        k = self.to_k(ctx).view(b, skv, self.heads, self.head_dim)
        v = self.to_v(ctx).view(b, skv, self.heads, self.head_dim)
        out = ops.attention(q, k, v).reshape(b, sq, self.heads * self.head_dim)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        value, gate = self.proj(x).chunk(2, dim=-1)
        return value * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU feed-forward (exact gelu): net = [GEGLU, Dropout, Linear]."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList(
            [GEGLU(dim, dim * mult), nn.Dropout(0.0), nn.Linear(dim * mult, dim)]
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """Self-attn -> cross-attn -> GEGLU FF, each pre-LayerNormed + residual."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, head_dim)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, head_dim, context_dim=context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    """Spatial transformer over NHWC features (linear projection variant):
    GroupNorm -> flatten HW -> proj_in -> blocks -> proj_out -> + residual."""

    def __init__(self, channels: int, heads: int, head_dim: int, depth: int,
                 context_dim: int):
        super().__init__()
        inner = heads * head_dim
        self.norm = GroupNorm(32, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, head_dim, context_dim)
             for _ in range(depth)]
        )
        self.proj_out = nn.Linear(inner, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        residual = x
        x = self.proj_in(self.norm(x).reshape(b, h * w, c))
        for block in self.transformer_blocks:
            x = block(x, context)
        return self.proj_out(x).reshape(b, h, w, c) + residual
