"""Vendored HF checkpoint config facts for the weight sources the reference
binds (src/pipeline.py:30-43 and :82-154): the port's copy of the JAX
package's ``tools/hf_vendored.py``, value for value.

These dicts pin the *architecture-relevant subset* of each checkpoint's
config.json so the converter and its tests are validated against the real
checkpoint layouts without network egress.  Provenance per entry:

  * SDXL_UNET_CONFIG / VAE_CONFIG / CONTROLNET_* — the public
    stabilityai/stable-diffusion-xl-base-1.0, madebyollin/sdxl-vae-fp16-fix
    and diffusers/controlnet-canny-sdxl-1.0[-small] configs; these are
    stable, widely mirrored facts.
  * SSD1B_UNET_CONFIG — **reconstructed** from public descriptions of
    segmind/SSD-1B (distillation paper arXiv:2401.02677, community UNet
    introspection): down path prunes the deep blocks 10->4, the mid block is
    removed entirely (``mid_block_type: null`` — the diffusers feature added
    for SSD-1B), and the up path is asymmetric
    (``reverse_transformer_layers_per_block``, the other SSD-1B-motivated
    diffusers feature), keeping one 10-deep module. Totals ~1.29 B params
    (fp16 shard ~2.6 GB, matching the shipped checkpoint size).
    ``tools/bring_up.sh`` re-verifies this dict against the downloaded
    config.json on the first machine with egress and fails loudly on drift;
    the converter itself always re-derives the config from the real
    config.json (tools/hf_config.py), so a drift here only affects the
    random-weight bench topology, never converted real-weight runs.

Entries for attention-free block positions in the nested lists are
placeholders (diffusers ignores them), normalized to 0/ignored by
tools/hf_config.py.
"""

from __future__ import annotations

SDXL_UNET_CONFIG = {
    "in_channels": 4,
    "out_channels": 4,
    "block_out_channels": [320, 640, 1280],
    "layers_per_block": 2,
    "down_block_types": [
        "DownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
    ],
    "up_block_types": ["CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"],
    "mid_block_type": "UNetMidBlock2DCrossAttn",
    "transformer_layers_per_block": [1, 2, 10],
    "attention_head_dim": [5, 10, 20],
    "num_attention_heads": None,
    "cross_attention_dim": 2048,
    "addition_embed_type": "text_time",
    "addition_time_embed_dim": 256,
    "projection_class_embeddings_input_dim": 2816,
    "norm_eps": 1e-5,
    "norm_num_groups": 32,
}

# diffusers UNet2DConditionModel param count for the SDXL-base-1.0 config —
# the published number (model card / `unet.num_parameters()`).
SDXL_UNET_PARAM_COUNT = 2_567_463_684

SSD1B_UNET_CONFIG = {
    **SDXL_UNET_CONFIG,
    "mid_block_type": None,
    "transformer_layers_per_block": [[1, 1], [2, 2], [4, 4]],
    "reverse_transformer_layers_per_block": [[4, 4, 10], [2, 1, 1], [1, 1, 1]],
}

CONTROLNET_COMMON = {
    "in_channels": 4,
    "block_out_channels": [320, 640, 1280],
    "layers_per_block": 2,
    "conditioning_channels": 3,
    "conditioning_embedding_out_channels": [16, 32, 96, 256],
    "cross_attention_dim": 2048,
    "addition_embed_type": "text_time",
    "addition_time_embed_dim": 256,
    "projection_class_embeddings_input_dim": 2816,
    "attention_head_dim": [5, 10, 20],
    "num_attention_heads": None,
    "norm_eps": 1e-5,
    "norm_num_groups": 32,
}

# diffusers/controlnet-canny-sdxl-1.0 — full encoder clone of the SDXL UNet.
CONTROLNET_FULL_CONFIG = {
    **CONTROLNET_COMMON,
    "down_block_types": [
        "DownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
    ],
    "mid_block_type": "UNetMidBlock2DCrossAttn",
    "transformer_layers_per_block": [1, 2, 10],
}

# diffusers/controlnet-canny-sdxl-1.0-small — conv-only distilled variant
# (no attention anywhere; mid block without attention). ~7x smaller.
CONTROLNET_SMALL_CONFIG = {
    **CONTROLNET_COMMON,
    "down_block_types": ["DownBlock2D", "DownBlock2D", "DownBlock2D"],
    "mid_block_type": "UNetMidBlock2D",
    "transformer_layers_per_block": [1, 2, 10],  # ignored: no CrossAttn blocks
}

# stabilityai/sdxl-vae == madebyollin/sdxl-vae-fp16-fix architecture
# (the fp16-fix re-trains weights, not topology).
VAE_CONFIG = {
    "in_channels": 3,
    "out_channels": 3,
    "latent_channels": 4,
    "block_out_channels": [128, 256, 512, 512],
    "layers_per_block": 2,
    "down_block_types": ["DownEncoderBlock2D"] * 4,
    "up_block_types": ["UpDecoderBlock2D"] * 4,
    "norm_num_groups": 32,
    "scaling_factor": 0.13025,
}

# transformers CLIPTextConfig fields for SDXL's two text towers
# (stabilityai/stable-diffusion-xl-base-1.0 text_encoder / text_encoder_2).
CLIP_VIT_L_TEXT_CONFIG = {
    "vocab_size": 49408,
    "hidden_size": 768,
    "intermediate_size": 3072,
    "num_hidden_layers": 12,
    "num_attention_heads": 12,
    "max_position_embeddings": 77,
    "hidden_act": "quick_gelu",
    "projection_dim": 768,
}

CLIP_BIGG_TEXT_CONFIG = {
    "vocab_size": 49408,
    "hidden_size": 1280,
    "intermediate_size": 5120,
    "num_hidden_layers": 32,
    "num_attention_heads": 20,
    "max_position_embeddings": 77,
    "hidden_act": "gelu",
    "projection_dim": 1280,
}

# openai/clip-vit-base-patch16 (the CLIPScore backbone, reference
# src/metrics.py:184-186): full CLIPModel (vision + text + projections).
CLIP_B16_CONFIG = {
    "projection_dim": 512,
    "text_config": {
        "vocab_size": 49408,
        "hidden_size": 512,
        "intermediate_size": 2048,
        "num_hidden_layers": 12,
        "num_attention_heads": 8,
        "max_position_embeddings": 77,
        "hidden_act": "quick_gelu",
    },
    "vision_config": {
        "image_size": 224,
        "patch_size": 16,
        "hidden_size": 768,
        "intermediate_size": 3072,
        "num_hidden_layers": 12,
        "num_attention_heads": 12,
        "hidden_act": "quick_gelu",
    },
}

# facebook DINO ViT-B/8 (torch.hub dino_vitb8, reference src/metrics.py:117).
DINO_VITB8 = {
    "embed_dim": 768,
    "depth": 12,
    "num_heads": 12,
    "patch_size": 8,
    "image_size": 224,
}
