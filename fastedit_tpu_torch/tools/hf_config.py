"""Derive the port's model configs from HF/diffusers config.json dicts (a
copy of the JAX package's ``tools/hf_config.py`` on ``models/configs.py``).

The authoritative source of architecture facts at conversion time is the
checkpoint's own config.json (SURVEY.md §7 hard part #3: SSD-1B's pruned
topology must come from the checkpoint, not from hardcoded constants).
These functions normalize diffusers' config quirks:

  * ``transformer_layers_per_block``: int | per-block list | per-block list
    of per-layer lists (SSD-1B nesting).
  * ``reverse_transformer_layers_per_block``: up-path override (SSD-1B);
    when absent the up path mirrors the down path.
  * ``attention_head_dim`` historically means *head count* in SDXL UNet
    configs when ``num_attention_heads`` is null.
  * ``DownBlock2D`` (no attention) == transformer depth 0.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from fastedit_tpu_torch.models.configs import (
    CLIPTextConfig,
    ControlNetConfig,
    UNetConfig,
    VAEConfig,
)


def _per_block_per_layer(
    value, n_blocks: int, layers_per_block: int
) -> Tuple[Tuple[int, ...], ...]:
    """Normalize transformer_layers_per_block to per-block per-layer tuples."""
    if isinstance(value, int):
        value = [value] * n_blocks
    out: List[Tuple[int, ...]] = []
    for v in value:
        if isinstance(v, (list, tuple)):
            assert len(v) == layers_per_block, (v, layers_per_block)
            out.append(tuple(int(x) for x in v))
        else:
            out.append((int(v),) * layers_per_block)
    assert len(out) == n_blocks
    return tuple(out)


def unet_config_from_hf(cfg: Dict[str, Any]) -> UNetConfig:
    block_out = tuple(cfg["block_out_channels"])
    n = len(block_out)
    layers = int(cfg.get("layers_per_block", 2))
    down_types = cfg.get("down_block_types", ["CrossAttnDownBlock2D"] * n)
    up_types = cfg.get("up_block_types", ["CrossAttnUpBlock2D"] * n)

    tlpb = _per_block_per_layer(
        cfg.get("transformer_layers_per_block", 1), n, layers
    )
    down = tuple(
        tlpb[i] if down_types[i] == "CrossAttnDownBlock2D" else (0,) * layers
        for i in range(n)
    )

    rev = cfg.get("reverse_transformer_layers_per_block")
    if rev is not None:
        up = _per_block_per_layer(rev, n, layers + 1)
    else:
        # mirror: up block i corresponds to down block n-1-i, one extra layer
        up = tuple(
            (tlpb[n - 1 - i][0],) * (layers + 1) for i in range(n)
        )
    up = tuple(
        up[i] if up_types[i] == "CrossAttnUpBlock2D" else (0,) * (layers + 1)
        for i in range(n)
    )

    heads = cfg.get("num_attention_heads") or cfg["attention_head_dim"]
    if isinstance(heads, int):
        heads = [heads] * n
    mid_type = cfg.get("mid_block_type", "UNetMidBlock2DCrossAttn")
    if mid_type is None:
        mid = None
    elif mid_type == "UNetMidBlock2D":
        mid = 0
    else:
        mid = int(tlpb[-1][-1])

    return UNetConfig(
        in_channels=int(cfg.get("in_channels", 4)),
        out_channels=int(cfg.get("out_channels", 4)),
        block_out_channels=block_out,
        layers_per_block=layers,
        down_transformer_layers=down,
        mid_transformer_layers=mid,
        up_transformer_layers=up,
        num_attention_heads=tuple(int(h) for h in heads),
        cross_attention_dim=int(cfg.get("cross_attention_dim", 2048)),
        addition_time_embed_dim=int(cfg.get("addition_time_embed_dim", 256)),
        projection_class_embeddings_input_dim=int(
            cfg.get("projection_class_embeddings_input_dim", 2816)
        ),
        norm_eps=float(cfg.get("norm_eps", 1e-5)),
        norm_groups=int(cfg.get("norm_num_groups", 32)),
    )


def controlnet_config_from_hf(cfg: Dict[str, Any]) -> ControlNetConfig:
    import dataclasses

    unet = unet_config_from_hf(cfg)
    # ControlNet is an encoder clone — it has no up path; normalize the
    # (unused) up depths to zeros so configs compare canonically.
    layers = unet.layers_per_block + 1
    unet = dataclasses.replace(
        unet,
        up_transformer_layers=tuple(
            (0,) * layers for _ in unet.block_out_channels
        ),
    )
    return ControlNetConfig(
        unet=unet,
        conditioning_channels=int(cfg.get("conditioning_channels", 3)),
        conditioning_embedding_channels=tuple(
            cfg.get("conditioning_embedding_out_channels", (16, 32, 96, 256))
        ),
    )


def vae_config_from_hf(cfg: Dict[str, Any]) -> VAEConfig:
    return VAEConfig(
        in_channels=int(cfg.get("in_channels", 3)),
        latent_channels=int(cfg.get("latent_channels", 4)),
        block_out_channels=tuple(cfg["block_out_channels"]),
        layers_per_block=int(cfg.get("layers_per_block", 2)),
        norm_groups=int(cfg.get("norm_num_groups", 32)),
        scaling_factor=float(cfg.get("scaling_factor", 0.13025)),
    )


def clip_text_config_from_hf(
    cfg: Dict[str, Any], with_projection: bool
) -> CLIPTextConfig:
    return CLIPTextConfig(
        vocab_size=int(cfg["vocab_size"]),
        hidden_size=int(cfg["hidden_size"]),
        num_layers=int(cfg["num_hidden_layers"]),
        num_heads=int(cfg["num_attention_heads"]),
        intermediate_size=int(cfg["intermediate_size"]),
        max_positions=int(cfg.get("max_position_embeddings", 77)),
        hidden_act=cfg.get("hidden_act", "quick_gelu"),
        eos_token_id=int(cfg.get("eos_token_id", 49407)),
        projection_dim=int(cfg["projection_dim"]) if with_projection else None,
        layer_norm_eps=float(cfg.get("layer_norm_eps", 1e-5)),
    )
