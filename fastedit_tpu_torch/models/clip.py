"""CLIP text towers (transformers' CLIPTextModel[WithProjection] names).

SDXL conditions on the concatenated penultimate hidden states of CLIP
ViT-L/14 (768-d) and OpenCLIP ViT-bigG/14 (1280-d), plus bigG's projected
pooled embedding.  77-token sequences are tiny: attention here is a plain
fp32-softmax einsum with a causal mask.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from fastedit_tpu_torch.models.configs import CLIPTextConfig
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

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, s, c = x.shape
        d = c // self.heads
        shape = (b, s, self.heads, d)
        q = self.q_proj(x).view(shape)
        k = self.k_proj(x).view(shape)
        v = self.v_proj(x).view(shape)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (d**-0.5)
        probs = torch.softmax(logits + mask, dim=-1).to(v.dtype)
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
