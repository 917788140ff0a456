"""CLIP text towers and the CLIP vision tower (transformers' names).

SDXL conditions on the concatenated penultimate hidden states of CLIP
ViT-L/14 (768-d) and OpenCLIP ViT-bigG/14 (1280-d), plus bigG's projected
pooled embedding.  77-token sequences are tiny: attention here is a plain
fp32-softmax einsum with a causal mask.  The vision tower (ViT-B/16) is the
CLIP score's image encoder (``metrics/calculator.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from fastedit_tpu_torch.models.configs import CLIPTextConfig, CLIPVisionConfig
from fastedit_tpu_torch.models.layers import LayerNorm


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu(x)
    raise ValueError(f"unsupported activation {name!r}")


class CLIPAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, s, c = x.shape
        d = c // self.heads
        shape = (b, s, self.heads, d)
        q = self.q_proj(x).view(shape)
        k = self.k_proj(x).view(shape)
        v = self.v_proj(x).view(shape)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (d**-0.5)
        if mask is not None:
            logits = logits + mask
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, c)
        return self.out_proj(out)


class _MLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = cfg.hidden_act
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(_act(self.act, self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg.hidden_size, cfg.num_heads)
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp = _MLP(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_positions, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)


@dataclasses.dataclass
class CLIPTextOutput:
    last_hidden_state: torch.Tensor  # [B, S, D] after the final LayerNorm
    penultimate_hidden_state: torch.Tensor  # [B, S, D] input of the last layer
    pooled_output: torch.Tensor  # [B, D or projection_dim]


class CLIPTextModel(nn.Module):
    """CLIP text tower; returns final, penultimate and pooled outputs.

    ``pooled_output`` is the final-LayerNormed state at the first EOS token
    (at the highest token id for configs with the legacy eos_token_id 2),
    through ``text_projection`` when configured (OpenCLIP bigG)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.config = cfg
        self.text_model = _TextTransformer(cfg)
        if cfg.projection_dim is not None:
            self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, input_ids: torch.Tensor) -> CLIPTextOutput:
        cfg = self.config
        tm = self.text_model
        b, s = input_ids.shape
        if s > cfg.max_positions:
            raise ValueError(f"{s} tokens > max_positions {cfg.max_positions}")
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding.weight[:s]
        mask = torch.triu(
            torch.full((s, s), float("-inf"), device=x.device), diagonal=1
        )[None, None]
        penultimate = x
        for i, layer in enumerate(tm.encoder.layers):
            if i == cfg.num_layers - 1:
                penultimate = x
            x = layer(x, mask)
        x = tm.final_layer_norm(x)
        if cfg.eos_token_id == 2:
            eos_pos = input_ids.argmax(dim=-1)
        else:
            eos_pos = (input_ids == cfg.eos_token_id).int().argmax(dim=-1)
        pooled = x[torch.arange(b, device=x.device), eos_pos]
        if cfg.projection_dim is not None:
            pooled = self.text_projection(pooled)
        return CLIPTextOutput(x, penultimate, pooled)


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        n = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(n, cfg.hidden_size)


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)


class CLIPVisionModel(nn.Module):
    """CLIP vision tower (ViT): patch conv, CLS token, pre and post
    LayerNorm, no attention mask.  Input [B, H, W, 3], resized and
    CLIP-normalised; returns the projected image embedding [B,
    projection_dim], what the CLIP score reads."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.config = cfg
        self.vision_model = _VisionTransformer(cfg)
        self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        vm = self.vision_model
        emb = vm.embeddings
        x = emb.patch_embedding(pixels.permute(0, 3, 1, 2).to(emb.patch_embedding.weight.dtype))
        x = x.flatten(2).transpose(1, 2)  # [B, patches, D], patches row-major
        cls = emb.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + emb.position_embedding.weight[None].to(x.dtype)
        x = vm.pre_layrnorm(x)
        for layer in vm.encoder.layers:
            x = layer(x, None)
        return self.visual_projection(vm.post_layernorm(x[:, 0]))
