"""Model architecture configs: SDXL, SSD-1B, ControlNet variants, VAE, CLIP.

One config-driven UNet class covers both model families (reference model
registry at src/pipeline.py:30-43: "sdxl" -> stabilityai/stable-diffusion-xl-
base-1.0 [+ LCM-LoRA fused offline], "ssd-1b" -> segmind/SSD-1B with the
latent-consistency/lcm-ssd-1b full LCM UNet).

The values below describe the architectures as shipped on the HF Hub; the
checkpoint converter (tools/convert_checkpoint.py) re-derives every field
from the checkpoint's own config.json at conversion time, so these constants
are defaults/documentation, not load-bearing for real-weight runs.  The
"tiny" configs are random-weight smoke models with the real topology
(SURVEY.md §4) used by tests and the CPU demo path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Config for UNet2DConditionModel (SDXL family).

    ``down_transformer_layers[i][j]`` is the transformer depth after resnet
    ``j`` of down block ``i`` (0 = conv-only, covers DownBlock2D and SSD-1B's
    per-layer pruning).  ``up_transformer_layers`` likewise per up block
    (``layers_per_block + 1`` entries each).  ``mid_transformer_layers`` is
    the mid block's transformer depth (0 = attention-free mid, None = no mid
    block at all).
    """

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    layers_per_block: int = 2
    down_transformer_layers: Tuple[Tuple[int, ...], ...] = ((0, 0), (2, 2), (10, 10))
    mid_transformer_layers: Optional[int] = 10
    up_transformer_layers: Tuple[Tuple[int, ...], ...] = (
        (10, 10, 10),
        (2, 2, 2),
        (0, 0, 0),
    )
    num_attention_heads: Tuple[int, ...] = (5, 10, 20)
    cross_attention_dim: int = 2048
    addition_time_embed_dim: int = 256
    # pooled text emb (1280) + 6 time ids x 256 = 2816 for SDXL.
    projection_class_embeddings_input_dim: int = 2816
    norm_eps: float = 1e-5
    norm_groups: int = 32

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def __post_init__(self):
        n = len(self.block_out_channels)
        assert len(self.down_transformer_layers) == n
        assert len(self.up_transformer_layers) == n
        assert len(self.num_attention_heads) == n
        for layers in self.down_transformer_layers:
            assert len(layers) == self.layers_per_block
        for layers in self.up_transformer_layers:
            assert len(layers) == self.layers_per_block + 1


# SDXL-base-1.0 UNet (HF config: transformer_layers_per_block=[1,2,10] with
# block 0 a plain DownBlock2D, attention_head_dim=[5,10,20] interpreted as
# head count, 64-dim heads). ~2.57 B params.
SDXL_UNET = UNetConfig()

# SSD-1B (segmind/SSD-1B): distilled SDXL (arXiv:2401.02677).  Down path
# prunes the deep blocks 10->4, the **mid block is removed entirely**
# (diffusers mid_block_type: null — the feature SSD-1B motivated), and the
# up path is asymmetric (diffusers reverse_transformer_layers_per_block,
# also SSD-1B-motivated), keeping one 10-deep module next to the 640-ch
# skip.  1,300,195,844 params — the published "1.3 B" (fp16 shard ~2.6 GB).
# Reconstructed from public descriptions (see tools/hf_vendored.py
# provenance note); the converter re-derives the exact fields from the
# checkpoint's own config.json at conversion time, so real-weight runs
# never depend on this default.
SSD1B_UNET = UNetConfig(
    down_transformer_layers=((0, 0), (2, 2), (4, 4)),
    mid_transformer_layers=None,
    up_transformer_layers=((4, 4, 10), (2, 1, 1), (0, 0, 0)),
)

# Tiny smoke-model with the full SDXL topology shape (3 blocks, cross-attn,
# added-cond path) but ~1000x fewer params; runs the whole pipeline on CPU
# in seconds for tests.
TINY_UNET = UNetConfig(
    block_out_channels=(32, 64, 128),
    layers_per_block=1,
    down_transformer_layers=((0,), (1,), (2,)),
    mid_transformer_layers=1,
    up_transformer_layers=((2, 2), (1, 1), (0, 0)),
    num_attention_heads=(2, 4, 8),
    cross_attention_dim=64,
    addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=32 + 6 * 8,  # pooled 32 + 6 ids x 8
)


@dataclasses.dataclass(frozen=True)
class ControlNetConfig:
    """ControlNet = UNet encoder clone + cond embedding + zero convs."""

    unet: UNetConfig = SDXL_UNET
    conditioning_channels: int = 3
    conditioning_embedding_channels: Tuple[int, ...] = (16, 32, 96, 256)


# ControlNet is an encoder clone — no up path; up depths canonically zero.
_NO_UP = ((0, 0, 0), (0, 0, 0), (0, 0, 0))

# diffusers/controlnet-canny-sdxl-1.0 (full) — encoder clone of SDXL UNet.
SDXL_CONTROLNET_FULL = ControlNetConfig(
    unet=dataclasses.replace(SDXL_UNET, up_transformer_layers=_NO_UP)
)

# diffusers/controlnet-canny-sdxl-1.0-small — distilled conv-only variant
# (down_block_types all DownBlock2D, mid UNetMidBlock2D without attention);
# converter re-derives exact values from the checkpoint's config.json.
SDXL_CONTROLNET_SMALL = ControlNetConfig(
    unet=dataclasses.replace(
        SDXL_UNET,
        down_transformer_layers=((0, 0), (0, 0), (0, 0)),
        mid_transformer_layers=0,
        up_transformer_layers=_NO_UP,
    )
)

TINY_CONTROLNET = ControlNetConfig(
    unet=TINY_UNET, conditioning_embedding_channels=(8, 16)
)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL (SDXL VAE / fp16-fix VAE share this architecture)."""

    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.13025

    @property
    def downscale_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


SDXL_VAE = VAEConfig()
TINY_VAE = VAEConfig(
    block_out_channels=(16, 16, 32, 32), layers_per_block=1, norm_groups=8
)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP text tower.  SDXL uses two: ViT-L/14 + OpenCLIP ViT-bigG/14."""

    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_positions: int = 77
    hidden_act: str = "quick_gelu"  # "quick_gelu" (ViT-L) | "gelu" (bigG)
    eos_token_id: int = 49407
    projection_dim: Optional[int] = None  # bigG: 1280 (pooled via projection)
    layer_norm_eps: float = 1e-5


# text_encoder: openai CLIP ViT-L/14 (768-d, quick_gelu, no projection used
# by SDXL — penultimate hidden state only).
SDXL_TEXT_ENCODER = CLIPTextConfig()

# text_encoder_2: laion OpenCLIP ViT-bigG/14 (1280-d, gelu, projected pooled
# output feeds the added-cond embedding).
SDXL_TEXT_ENCODER_2 = CLIPTextConfig(
    hidden_size=1280,
    num_layers=32,
    num_heads=20,
    intermediate_size=5120,
    hidden_act="gelu",
    projection_dim=1280,
)

TINY_TEXT_ENCODER = CLIPTextConfig(
    vocab_size=1000,
    hidden_size=32,
    num_layers=2,
    num_heads=2,
    intermediate_size=64,
    eos_token_id=999,
)
@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP vision tower (ViT). Used by the CLIPScore metric (E10)."""

    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "quick_gelu"
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5


# openai/clip-vit-base-patch16 (the CLIPScore backbone, src/metrics.py:184-186)
CLIP_B16_VISION = CLIPVisionConfig()
CLIP_B16_TEXT = CLIPTextConfig(
    hidden_size=512, num_layers=12, num_heads=8, intermediate_size=2048,
    projection_dim=512,
)

TINY_CLIP_VISION = CLIPVisionConfig(
    image_size=32, patch_size=8, hidden_size=32, num_layers=2, num_heads=2,
    intermediate_size=64, projection_dim=32,
)
TINY_CLIP_TEXT = CLIPTextConfig(
    vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
    intermediate_size=64, eos_token_id=999, projection_dim=32,
)


TINY_TEXT_ENCODER_2 = CLIPTextConfig(
    vocab_size=1000,
    hidden_size=32,
    num_layers=2,
    num_heads=2,
    intermediate_size=64,
    hidden_act="gelu",
    eos_token_id=999,
    projection_dim=32,
)
