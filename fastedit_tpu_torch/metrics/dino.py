"""DINO ViT-B/8 attention keys and the structural distance (a port of the
JAX package's ``metrics/dino.py``).

The reference's torch.hub DINO pipeline (src/metrics.py:24-147): the MSE
between the cosine self-similarity maps of the layer-11 attention *keys* of
the source and the edited image.  The model returns the keys of the layer
asked for; no hooks.  timm names and layout: patch conv embedding, CLS
token, learned position embedding, pre-norm blocks with a fused qkv, exact
GELU MLP, LayerNorm eps 1e-6.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from fastedit_tpu_torch.models.layers import LayerNorm

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class DINOConfig:
    image_size: int = 224
    patch_size: int = 8
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-6


DINO_VITB8 = DINOConfig()
TINY_DINO = DINOConfig(image_size=32, patch_size=8, hidden_size=32, num_layers=2, num_heads=2)


class _Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)


class _MLP(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)


class DINOBlock(nn.Module):
    def __init__(self, cfg: DINOConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.norm1 = LayerNorm(d, cfg.layer_norm_eps)
        self.attn = _Attention(d)
        self.norm2 = LayerNorm(d, cfg.layer_norm_eps)
        self.mlp = _MLP(d, d * cfg.mlp_ratio)

    def forward(self, x: torch.Tensor):
        """(block output, keys [B, heads, tokens, head_dim])."""
        b, s, d = x.shape
        hd = d // self.heads
        qkv = self.attn.qkv(self.norm1(x)).view(b, s, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * hd**-0.5
        o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1).to(v.dtype), v)
        x = x + self.attn.proj(o.transpose(1, 2).reshape(b, s, d))
        h = self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))
        return x + h, k


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: DINOConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size, stride=cfg.patch_size)


class DINOViT(nn.Module):
    """DINO ViT returning the attention keys of one layer."""

    def __init__(self, cfg: DINOConfig):
        super().__init__()
        self.config = cfg
        n = (cfg.image_size // cfg.patch_size) ** 2
        self.patch_embed = _PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, cfg.hidden_size))
        self.blocks = nn.ModuleList([DINOBlock(cfg) for _ in range(cfg.num_layers)])

    def forward(self, pixels: torch.Tensor, layer: int = 11) -> torch.Tensor:
        """pixels: [B, H, W, 3], ImageNet-normalised.  Returns the keys
        [B, heads, tokens, head_dim] of ``layer`` (the blocks after it do
        not run: they change nothing it returns)."""
        if not 0 <= layer < self.config.num_layers:
            raise ValueError(f"layer {layer} out of range")
        proj = self.patch_embed.proj
        x = proj(pixels.permute(0, 3, 1, 2).to(proj.weight.dtype)).flatten(2).transpose(1, 2)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        for block in self.blocks[: layer + 1]:
            x, keys = block(x)
        return keys


def keys_self_similarity(keys: torch.Tensor) -> torch.Tensor:
    """Cosine self-similarity of head-concatenated keys: [B, heads, tokens,
    head_dim] -> [B, tokens, tokens] (reference src/metrics.py:71-83)."""
    b, h, t, d = keys.shape
    x = keys.permute(0, 2, 1, 3).reshape(b, t, h * d).float()
    norm = x.norm(dim=-1, keepdim=True)
    denom = (norm @ norm.transpose(1, 2)).clamp(min=1e-8)
    return (x @ x.transpose(1, 2)) / denom


def dino_distance(keys_src: torch.Tensor, keys_edit: torch.Tensor) -> torch.Tensor:
    """Per-image MSE between self-similarity maps [B] (reference
    src/metrics.py:138-147)."""
    diff = keys_self_similarity(keys_edit) - keys_self_similarity(keys_src)
    return diff.square().mean(dim=(1, 2))
