"""Every 3x3 stride-1 conv and every attention call of one edit, from the
model configs alone.

``chip_smoke.py`` uses it for the shapes at which each kernel is held
against its plain version and for the launch counts the main path must
show; the tests use it to hold the kernels' gates to the JAX package's.
Counts are per edit: the encoder runs once at batch B, the denoise loop
``steps`` times at batch 2B under CFG (the ControlNet conditioning tower
once at batch B), the decoder once per image at batch 1.
"""

from __future__ import annotations

from collections import Counter

from fastedit_tpu_torch.models.configs import ControlNetConfig, UNetConfig, VAEConfig
from fastedit_tpu_torch.models.unet import skip_channels

TEXT_TOKENS = 77


def _resnet(calls, n, hw, cin, cout):
    calls[(n, hw, hw, cin, cout)] += 1
    calls[(n, hw, hw, cout, cout)] += 1


def _transformers(attn, n, hw, ch, heads, depth):
    d = ch // heads
    attn[(n, hw * hw, hw * hw, heads, d)] += depth  # self-attention
    attn[(n, hw * hw, TEXT_TOKENS, heads, d)] += depth  # cross-attention


def unet_calls(cfg: UNetConfig, n: int, lat: int, decoder: bool = True):
    """(conv, attention) Counters of one UNet forward (``decoder=False``:
    the ControlNet's encoder clone, without its conditioning tower)."""
    conv, attn = Counter(), Counter()
    chans = list(cfg.block_out_channels)
    conv[(n, lat, lat, cfg.in_channels, chans[0])] += 1
    hw, prev = lat, chans[0]
    for i, ch in enumerate(chans):
        for j, depth in enumerate(cfg.down_transformer_layers[i]):
            _resnet(conv, n, hw, prev if j == 0 else ch, ch)
            _transformers(attn, n, hw, ch, cfg.num_attention_heads[i], depth)
        prev = ch
        if i < len(chans) - 1:
            hw //= 2  # strided downsample conv: not a 3x3 stride-1 call
    if cfg.mid_transformer_layers is not None:
        _resnet(conv, n, hw, chans[-1], chans[-1])
        _resnet(conv, n, hw, chans[-1], chans[-1])
        _transformers(attn, n, hw, chans[-1], cfg.num_attention_heads[-1],
                      cfg.mid_transformer_layers)
    if not decoder:
        return conv, attn
    skips = skip_channels(cfg)
    L = cfg.layers_per_block + 1
    for i, ch in enumerate(reversed(chans)):
        block_skips = skips[-L:][::-1]
        del skips[-L:]
        for j, depth in enumerate(cfg.up_transformer_layers[i]):
            _resnet(conv, n, hw, (prev if j == 0 else ch) + block_skips[j], ch)
            _transformers(attn, n, hw, ch, cfg.num_attention_heads[len(chans) - 1 - i], depth)
        prev = ch
        if i < len(chans) - 1:
            hw *= 2
            conv[(n, hw, hw, ch, ch)] += 1  # upsampler conv after nearest-2x
    conv[(n, lat, lat, chans[0], cfg.out_channels)] += 1
    return conv, attn


def cond_tower_calls(cfg: ControlNetConfig, n: int, px: int) -> Counter:
    """3x3 stride-1 convs of the ControlNet conditioning tower."""
    conv = Counter()
    ch = list(cfg.conditioning_embedding_channels)
    conv[(n, px, px, cfg.conditioning_channels, ch[0])] += 1
    hw = px
    for i in range(len(ch) - 1):
        conv[(n, hw, hw, ch[i], ch[i])] += 1
        hw //= 2
    conv[(n, hw, hw, ch[-1], cfg.unet.block_out_channels[0])] += 1
    return conv


def vae_calls(cfg: VAEConfig, n: int, px: int, encoder: bool):
    """(conv, attention) Counters of the VAE encoder or decoder."""
    conv, attn = Counter(), Counter()
    chans = list(cfg.block_out_channels)
    lat = px // cfg.downscale_factor
    top = chans[-1]
    if encoder:
        conv[(n, px, px, cfg.in_channels, chans[0])] += 1
        hw, prev = px, chans[0]
        for i, ch in enumerate(chans):
            for j in range(cfg.layers_per_block):
                _resnet(conv, n, hw, prev if j == 0 else ch, ch)
            prev = ch
            if i < len(chans) - 1:
                hw //= 2
    else:
        conv[(n, lat, lat, cfg.latent_channels, top)] += 1
    for _ in range(2):  # mid block resnets
        _resnet(conv, n, lat, top, top)
    attn[(n, lat * lat, lat * lat, 1, top)] += 1
    if encoder:
        conv[(n, lat, lat, top, 2 * cfg.latent_channels)] += 1
        return conv, attn
    hw, prev = lat, top
    for i, ch in enumerate(reversed(chans)):
        for j in range(cfg.layers_per_block + 1):
            _resnet(conv, n, hw, prev if j == 0 else ch, ch)
        prev = ch
        if i < len(chans) - 1:
            hw *= 2
            conv[(n, hw, hw, ch, ch)] += 1
    conv[(n, px, px, chans[0], cfg.in_channels)] += 1
    return conv, attn


def edit_calls(unet_cfg: UNetConfig, cn_cfg: ControlNetConfig, vae_cfg: VAEConfig,
               resolution: int, batch: int = 1, steps: int = 3, cfg_guidance: bool = True,
               control_res: int | None = None):
    """(conv, attention) Counters of every call one edit (or one
    ``edit_batch`` of ``batch`` images) makes, keyed by shape:
    conv (N, H, W, Cin, Cout), attention (B, Sq, Skv, heads, head_dim).
    ``control_res`` is the ControlNet conditioning image's size (the
    resolution for the full models)."""
    conv, attn = Counter(), Counter()
    lat = resolution // vae_cfg.downscale_factor
    nd = 2 * batch if cfg_guidance else batch
    c, a = vae_calls(vae_cfg, batch, resolution, encoder=True)
    conv += c
    attn += a
    conv += cond_tower_calls(cn_cfg, batch, control_res or resolution)
    for _ in range(steps):
        for c, a in (unet_calls(cn_cfg.unet, nd, lat, decoder=False),
                     unet_calls(unet_cfg, nd, lat)):
            conv += c
            attn += a
    for _ in range(batch):
        c, a = vae_calls(vae_cfg, 1, resolution, encoder=False)
        conv += c
        attn += a
    return conv, attn
