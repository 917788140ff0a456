"""Analytic FLOPs of the edit (MFU reporting): the port's copy of the JAX
package's ``utils/flops.py``, over the port's own configs.

Matmul / conv MACs only, 2 FLOPs per MAC (the usual MFU convention; norms
and elementwise work are left out), walking the same model configs the
pipeline builds from.  ``bench.py`` divides :func:`edit_flops` by the
measured device seconds and the H100's dense bf16 peak.
``tests/test_torch_bench.py`` holds every function here equal to the JAX
package's.
"""

from __future__ import annotations

from fastedit_tpu_torch.models.configs import (
    ControlNetConfig,
    UNetConfig,
    VAEConfig,
)


def _conv(hw: int, cin: int, cout: int, k: int = 3) -> float:
    """2 * H*W * Cin * Cout * k² (stride handled by passing the OUTPUT hw)."""
    return 2.0 * hw * hw * cin * cout * k * k


def _dense(tokens: float, cin: int, cout: int) -> float:
    return 2.0 * tokens * cin * cout


def _resnet(hw: int, cin: int, cout: int, temb: int | None) -> float:
    f = _conv(hw, cin, cout) + _conv(hw, cout, cout)
    if cin != cout:
        f += _conv(hw, cin, cout, k=1)
    if temb:
        f += _dense(1, temb, cout)
    return f


def _transformer2d(
    hw: int, c: int, depth: int, cross: int, seq_text: int = 77
) -> float:
    """Linear-projection Transformer2DModel: proj_in/out + depth blocks."""
    s = hw * hw
    f = 2 * _dense(s, c, c)  # proj_in + proj_out
    per_block = (
        # attn1 (self): q,k,v,out projections + QK^T + AV
        4 * _dense(s, c, c) + 2 * (2.0 * s * s * c)
        # attn2 (cross): q,out from/to c; k,v from cross dim; QK^T + AV
        + 2 * _dense(s, c, c)
        + 2 * _dense(seq_text, cross, c)
        + 2 * (2.0 * s * seq_text * c)
        # GEGLU ff: [c -> 8c] then [4c -> c]
        + _dense(s, c, 8 * c) + _dense(s, 4 * c, c)
    )
    return f + depth * per_block


def unet_flops(cfg: UNetConfig, latent_hw: int, seq_text: int = 77) -> float:
    """One UNet2DConditionModel forward, batch 1, matmul/conv MACs x2."""
    chans = list(cfg.block_out_channels)
    n = len(chans)
    temb = cfg.time_embed_dim
    cross = cfg.cross_attention_dim
    f = _conv(latent_hw, cfg.in_channels, chans[0])  # conv_in
    # time/add embeddings (tiny but free to count)
    f += _dense(1, chans[0], temb) + _dense(1, temb, temb)
    f += _dense(1, cfg.projection_class_embeddings_input_dim, temb)
    f += _dense(1, temb, temb)

    # down path
    hw = latent_hw
    out_ch = chans[0]
    for i in range(n):
        in_ch, out_ch = out_ch, chans[i]
        for j, depth in enumerate(cfg.down_transformer_layers[i]):
            f += _resnet(hw, in_ch if j == 0 else out_ch, out_ch, temb)
            if depth > 0:
                f += _transformer2d(hw, out_ch, depth, cross, seq_text)
        if i < n - 1:
            hw //= 2
            f += _conv(hw, out_ch, out_ch)  # stride-2 conv, output hw

    # mid
    if cfg.mid_transformer_layers is not None:
        c = chans[-1]
        f += 2 * _resnet(hw, c, c, temb)
        if cfg.mid_transformer_layers > 0:
            f += _transformer2d(hw, c, cfg.mid_transformer_layers, cross, seq_text)

    # up path (skip-concat inputs)
    rev = list(reversed(chans))
    out_ch = rev[0]
    for i in range(n):
        prev, out_ch = out_ch, rev[i]
        skip_res = rev[min(i + 1, n - 1)]
        L = cfg.layers_per_block + 1
        for j, depth in enumerate(cfg.up_transformer_layers[i]):
            skip = skip_res if j == L - 1 else out_ch
            cin = (prev if j == 0 else out_ch) + skip
            f += _resnet(hw, cin, out_ch, temb)
            if depth > 0:
                f += _transformer2d(hw, out_ch, depth, cross, seq_text)
        if i < n - 1:
            hw *= 2
            f += _conv(hw, out_ch, out_ch)  # conv after nearest-2x upsample

    f += _conv(latent_hw, chans[0], cfg.out_channels)  # conv_out
    return f


def controlnet_encoder_flops(
    ccfg: ControlNetConfig, latent_hw: int, seq_text: int = 77
) -> float:
    """ControlNet per-step work: conv_in + down path + mid + zero convs.

    Excludes the conditioning-embedding tower — the pipeline hoists it out
    of the denoise loop (timestep/CFG-invariant), so it is counted once per
    edit via :func:`controlnet_cond_tower_flops`.
    """
    cfg = ccfg.unet
    chans = list(cfg.block_out_channels)
    n = len(chans)
    temb = cfg.time_embed_dim
    f = _conv(latent_hw, cfg.in_channels, chans[0])
    f += _dense(1, chans[0], temb) + _dense(1, temb, temb)
    f += _dense(1, cfg.projection_class_embeddings_input_dim, temb)
    f += _dense(1, temb, temb)

    hw = latent_hw
    out_ch = chans[0]
    zero_convs = _conv(hw, chans[0], chans[0], k=1)  # conv_in's zero conv
    for i in range(n):
        in_ch, out_ch = out_ch, chans[i]
        for j, depth in enumerate(cfg.down_transformer_layers[i]):
            f += _resnet(hw, in_ch if j == 0 else out_ch, out_ch, temb)
            if depth > 0:
                f += _transformer2d(
                    hw, out_ch, depth, cfg.cross_attention_dim, seq_text
                )
            zero_convs += _conv(hw, out_ch, out_ch, k=1)
        if i < n - 1:
            hw //= 2
            f += _conv(hw, out_ch, out_ch)
            zero_convs += _conv(hw, out_ch, out_ch, k=1)
    if cfg.mid_transformer_layers is not None:
        c = chans[-1]
        f += 2 * _resnet(hw, c, c, temb)
        if cfg.mid_transformer_layers > 0:
            f += _transformer2d(
                hw, c, cfg.mid_transformer_layers, cfg.cross_attention_dim,
                seq_text,
            )
        zero_convs += _conv(hw, c, c, k=1)
    return f + zero_convs


def controlnet_cond_tower_flops(ccfg: ControlNetConfig, pixel_hw: int) -> float:
    """The conditioning-embedding tower, once per edit (hoisted)."""
    ch = list(ccfg.conditioning_embedding_channels)
    hw = pixel_hw
    f = _conv(hw, ccfg.conditioning_channels, ch[0])
    for i in range(len(ch) - 1):
        f += _conv(hw, ch[i], ch[i])
        hw //= 2
        f += _conv(hw, ch[i], ch[i + 1])
    f += _conv(hw, ch[-1], ccfg.unet.block_out_channels[0])
    return f


def _vae_mid(hw: int, c: int) -> float:
    # two resnets + single-head attention (qkv/out projections + QK^T + AV)
    s = hw * hw
    attn = 4 * _dense(s, c, c) + 2 * (2.0 * s * s * c)
    return 2 * _resnet(hw, c, c, None) + attn


def vae_encoder_flops(cfg: VAEConfig, pixel_hw: int) -> float:
    chans = list(cfg.block_out_channels)
    n = len(chans)
    hw = pixel_hw
    f = _conv(hw, cfg.in_channels, chans[0])
    out_ch = chans[0]
    for i in range(n):
        in_ch, out_ch = out_ch, chans[i]
        for j in range(cfg.layers_per_block):
            f += _resnet(hw, in_ch if j == 0 else out_ch, out_ch, None)
        if i < n - 1:
            hw //= 2
            f += _conv(hw, out_ch, out_ch)
    f += _vae_mid(hw, chans[-1])
    f += _conv(hw, chans[-1], 2 * cfg.latent_channels)
    f += _conv(hw, 2 * cfg.latent_channels, 2 * cfg.latent_channels, k=1)
    return f


def vae_decoder_flops(cfg: VAEConfig, pixel_hw: int) -> float:
    chans = list(cfg.block_out_channels)
    n = len(chans)
    rev = list(reversed(chans))
    hw = pixel_hw // cfg.downscale_factor
    f = _conv(hw, cfg.latent_channels, cfg.latent_channels, k=1)  # post_quant
    f += _conv(hw, cfg.latent_channels, rev[0])
    f += _vae_mid(hw, rev[0])
    out_ch = rev[0]
    for i in range(n):
        in_ch, out_ch = out_ch, rev[i]
        for j in range(cfg.layers_per_block + 1):
            f += _resnet(hw, in_ch if j == 0 else out_ch, out_ch, None)
        if i < n - 1:
            hw *= 2
            f += _conv(hw, out_ch, out_ch)
    f += _conv(hw, chans[0], cfg.in_channels)
    return f


def edit_flops(
    unet_cfg: UNetConfig,
    cn_cfg: ControlNetConfig,
    vae_cfg: VAEConfig,
    resolution: int,
    num_steps_run: int,
    do_cfg: bool,
    batch: int = 1,
) -> float:
    """Matmul/conv FLOPs of one edit's pixel path (``pipeline/graphs.py``).

    VAE encode + hoisted ControlNet cond tower (batch B) -> num_steps_run x
    (ControlNet encoder + UNet) at batch 2B (CFG) or B -> VAE decode (batch
    B).  Text encoding is outside it (cached per prompt) and excluded.
    """
    lat_hw = resolution // vae_cfg.downscale_factor
    denoise_b = (2 if do_cfg else 1) * batch
    per_step = unet_flops(unet_cfg, lat_hw) + controlnet_encoder_flops(
        cn_cfg, lat_hw
    )
    return batch * (
        vae_encoder_flops(vae_cfg, resolution)
        + controlnet_cond_tower_flops(cn_cfg, resolution)
        + vae_decoder_flops(vae_cfg, resolution)
    ) + num_steps_run * denoise_b * per_step
