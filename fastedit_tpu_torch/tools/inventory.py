"""Every conv, GroupNorm, attention, LayerNorm and Canny call of one edit, by
stage, from the model configs alone, and the kernel each one reaches.

:func:`edit_sites` lists the calls as (stage, op, key) with their counts:

* ``("conv", (N, H, W, Cin, Cout))``: a plain 3x3 stride-1 conv (stems,
  ``conv_out``, the ControlNet conditioning tower);
* ``("resnet", (N, H, W, Cin, Cout, groups, temb))``: a ResnetBlock2D, two
  3x3 convs and two GroupNorm+SiLU (or, fused, the GroupNorm statistics of
  each conv's prologue), with a time embedding or not;
* ``("up2", (N, H, W, C, C))``: an upsampler, at its low-res input;
* ``("down2", (N, H, W, C, Cout, asymmetric))``: a stride-2 conv;
* ``("gn", (N, H, W, C, groups, act))``: any other GroupNorm (``conv_norm_out``,
  the transformers' and the VAE attention's);
* ``("attn", (B, Sq, Skv, heads, head_dim))``;
* ``("ln", (N, S, C))``: a LayerNorm over rows of C values, three in each
  transformer block (:func:`prompt_sites` lists the CLIP text towers', two in
  each layer and the final one, for one call of the prompt encoder);
* ``("canny", (B, H, W))``: Canny prepare, once per edit in its own stage
  (``"prepare"``, outside the plan's stages), on the card one launch of
  the Canny kernel (``ops/canny.prepare``).

:func:`kernel_calls` routes each call as the modules dispatch it, asking
the kernel plan of its stage (``flags.takes`` inside ``flags.stage``), and
counts the calls each kernel takes, keyed by (kernel, shape).  The gates do
not depend on the dtype but one, so an fp32 edit (the quality mode) takes
the same calls to each kernel's fp32 instance, named ``<kernel>_f32``
(``kernel_calls(..., dtype=torch.float32)``); the exception is
``cross_attention``, bf16 only (:data:`BF16_ONLY`): fp32 cross-attention
takes the plain version.
``chip_smoke.py`` uses it for the shapes at which each kernel is held against
its plain version and for the launch counts the main path must show; the
tests hold it to the calls an edit makes.  Counts are per edit: the encoder
runs once at batch B, the denoise loop ``steps`` times at batch 2B under CFG
(the ControlNet conditioning tower once at batch B), the decoder once per
image at batch 1.
"""

from __future__ import annotations

import contextlib
from collections import Counter

import torch

from fastedit_tpu_torch.models.configs import (
    CLIPTextConfig, ControlNetConfig, UNetConfig, VAEConfig)
from fastedit_tpu_torch.models.unet import skip_channels
from fastedit_tpu_torch.ops import canny, conv3x3, conv_fused, flags
from fastedit_tpu_torch.ops import flash_attention as fa
from fastedit_tpu_torch.ops import fused_groupnorm, layer_norm

TEXT_TOKENS = 77
TRANSFORMER_GROUPS = 32
BF16_KERNELS = ("conv3x3", "conv3x3_fused", "conv3x3_up2", "conv3x3_down2", "group_norm",
                "group_norm_scale_shift", *(f"flash_attention_d{d}" for d in fa.HEAD_DIMS),
                "canny_prepare", "layer_norm", "cross_attention")
BF16_ONLY = ("cross_attention",)  # kernels without an fp32 instance
F32_SUFFIX = "_f32"
F32_KERNELS = tuple(k + F32_SUFFIX for k in BF16_KERNELS if k not in BF16_ONLY)
KERNELS = (*BF16_KERNELS, *F32_KERNELS)


def _transformer(s, n, hw, ch, heads, depth):
    if depth <= 0:
        return
    d = ch // heads
    s[("gn", (n, hw, hw, ch, TRANSFORMER_GROUPS, None))] += 1
    s[("attn", (n, hw * hw, hw * hw, heads, d))] += depth  # self-attention
    s[("attn", (n, hw * hw, TEXT_TOKENS, heads, d))] += depth  # cross-attention
    s[("ln", (n, hw * hw, ch))] += 3 * depth


def unet_sites(cfg: UNetConfig, n: int, lat: int, decoder: bool = True) -> Counter:
    """One UNet forward (``decoder=False``: the ControlNet's encoder clone,
    without its conditioning tower)."""
    s = Counter()
    chans, groups = list(cfg.block_out_channels), cfg.norm_groups
    s[("conv", (n, lat, lat, cfg.in_channels, chans[0]))] += 1
    hw, prev = lat, chans[0]
    for i, ch in enumerate(chans):
        for j, depth in enumerate(cfg.down_transformer_layers[i]):
            s[("resnet", (n, hw, hw, prev if j == 0 else ch, ch, groups, True))] += 1
            _transformer(s, n, hw, ch, cfg.num_attention_heads[i], depth)
        prev = ch
        if i < len(chans) - 1:
            s[("down2", (n, hw, hw, ch, ch, False))] += 1
            hw //= 2
    if cfg.mid_transformer_layers is not None:
        s[("resnet", (n, hw, hw, chans[-1], chans[-1], groups, True))] += 2
        _transformer(s, n, hw, chans[-1], cfg.num_attention_heads[-1],
                     cfg.mid_transformer_layers)
    if not decoder:
        return s
    skips = skip_channels(cfg)
    L = cfg.layers_per_block + 1
    for i, ch in enumerate(reversed(chans)):
        block_skips = skips[-L:][::-1]
        del skips[-L:]
        for j, depth in enumerate(cfg.up_transformer_layers[i]):
            cin = (prev if j == 0 else ch) + block_skips[j]
            s[("resnet", (n, hw, hw, cin, ch, groups, True))] += 1
            _transformer(s, n, hw, ch, cfg.num_attention_heads[len(chans) - 1 - i], depth)
        prev = ch
        if i < len(chans) - 1:
            s[("up2", (n, hw, hw, ch, ch))] += 1
            hw *= 2
    s[("gn", (n, lat, lat, chans[0], groups, "silu"))] += 1
    s[("conv", (n, lat, lat, chans[0], cfg.out_channels))] += 1
    return s


def cond_tower_sites(cfg: ControlNetConfig, n: int, px: int) -> Counter:
    """The ControlNet conditioning tower: 3x3 convs and stride-2 convs."""
    s = Counter()
    ch = list(cfg.conditioning_embedding_channels)
    s[("conv", (n, px, px, cfg.conditioning_channels, ch[0]))] += 1
    hw = px
    for i in range(len(ch) - 1):
        s[("conv", (n, hw, hw, ch[i], ch[i]))] += 1
        s[("down2", (n, hw, hw, ch[i], ch[i + 1], False))] += 1
        hw //= 2
    s[("conv", (n, hw, hw, ch[-1], cfg.unet.block_out_channels[0]))] += 1
    return s


def vae_sites(cfg: VAEConfig, n: int, px: int, encoder: bool) -> Counter:
    """The VAE encoder or decoder."""
    s = Counter()
    chans, groups = list(cfg.block_out_channels), cfg.norm_groups
    lat = px // cfg.downscale_factor
    top = chans[-1]
    if encoder:
        s[("conv", (n, px, px, cfg.in_channels, chans[0]))] += 1
        hw, prev = px, chans[0]
        for i, ch in enumerate(chans):
            for j in range(cfg.layers_per_block):
                s[("resnet", (n, hw, hw, prev if j == 0 else ch, ch, groups, False))] += 1
            prev = ch
            if i < len(chans) - 1:
                s[("down2", (n, hw, hw, ch, ch, True))] += 1
                hw //= 2
    else:
        s[("conv", (n, lat, lat, cfg.latent_channels, top))] += 1
    s[("resnet", (n, lat, lat, top, top, groups, False))] += 2  # mid block
    s[("gn", (n, lat, lat, top, groups, None))] += 1
    s[("attn", (n, lat * lat, lat * lat, 1, top))] += 1
    if encoder:
        s[("gn", (n, lat, lat, top, groups, "silu"))] += 1
        s[("conv", (n, lat, lat, top, 2 * cfg.latent_channels))] += 1
        return s
    hw, prev = lat, top
    for i, ch in enumerate(reversed(chans)):
        for j in range(cfg.layers_per_block + 1):
            s[("resnet", (n, hw, hw, prev if j == 0 else ch, ch, groups, False))] += 1
        prev = ch
        if i < len(chans) - 1:
            s[("up2", (n, hw, hw, ch, ch))] += 1
            hw *= 2
    s[("gn", (n, px, px, chans[0], groups, "silu"))] += 1
    s[("conv", (n, px, px, chans[0], cfg.in_channels))] += 1
    return s


def edit_sites(unet_cfg: UNetConfig, cn_cfg: ControlNetConfig, vae_cfg: VAEConfig,
               resolution: int, batch: int = 1, steps: int = 3, cfg_guidance: bool = True,
               control_res: int | None = None) -> Counter:
    """Every call of one edit (or one ``edit_batch`` of ``batch`` images) as
    (stage, op, key) -> count.  ``control_res`` is the ControlNet
    conditioning image's size (the resolution for the full models)."""
    s = Counter()
    lat = resolution // vae_cfg.downscale_factor
    nd = 2 * batch if cfg_guidance else batch

    def add(stage, sites, times=1):
        for (op, key), c in sites.items():
            s[(stage, op, key)] += c * times

    s[("prepare", "canny", (batch, resolution, resolution))] += 1
    add("encode", vae_sites(vae_cfg, batch, resolution, encoder=True))
    add("denoise", cond_tower_sites(cn_cfg, batch, control_res or resolution))
    add("denoise", unet_sites(cn_cfg.unet, nd, lat, decoder=False), steps)
    add("denoise", unet_sites(unet_cfg, nd, lat), steps)
    add("decode", vae_sites(vae_cfg, 1, resolution, encoder=False), batch)
    return s


def prompt_sites(te1: CLIPTextConfig, te2: CLIPTextConfig, n: int) -> Counter:
    """One call of the prompt encoder on ``n`` (padded) prompts, both CLIP
    text towers: every layer runs (the penultimate state is read before the
    last), then the final LayerNorm."""
    s = Counter()
    for cfg in (te1, te2):
        s[("prompts", "ln", (n, TEXT_TOKENS, cfg.hidden_size))] += 2 * cfg.num_layers + 1
    return s


def edit_calls(*args, **kwargs):
    """(conv, attention) Counters of every 3x3 stride-1 conv, keyed (N, H,
    W, Cin, Cout) (an upsampler's at its 2x input), and every attention
    call, keyed (B, Sq, Skv, heads, head_dim); the arguments of
    :func:`edit_sites`."""
    conv, attn = Counter(), Counter()
    for (_, op, key), c in edit_sites(*args, **kwargs).items():
        if op == "conv":
            conv[key] += c
        elif op == "resnet":
            n, h, w, cin, cout = key[:5]
            conv[(n, h, w, cin, cout)] += c
            conv[(n, h, w, cout, cout)] += c
        elif op == "up2":
            n, h, w, cin, cout = key
            conv[(n, 2 * h, 2 * w, cin, cout)] += c
        elif op == "attn":
            attn[key] += c
    return conv, attn


def _conv(kernel, key):
    """``[(kernel, key)]`` where the plan takes the conv (N, H, W, Cin, Cout)
    that ``key`` starts with."""
    n, h, w, cin, cout = key[:5]
    return [(kernel, key)] if flags.takes(kernel, (n, h, w, cin), (cout, cin, 3, 3)) else []


def _gn(key, kernel="group_norm"):
    n, h, w, c, groups = key[:5]
    return [(kernel, key)] if flags.takes(kernel, (n, h, w, c), groups) else []


def route(op: str, key: tuple, dtype: torch.dtype = torch.bfloat16) -> list:
    """The kernel calls one site makes in the current stage, in ``dtype``, as
    (kernel, shape key): ``conv3x3`` (N, H, W, Cin, Cout); ``conv3x3_fused``
    (N, H, W, Cin, Cout, per-batch bias, skip), each after the
    ``group_norm_scale_shift`` (N, H, W, C, groups) of its prologue;
    ``conv3x3_up2`` as the site; ``conv3x3_down2`` as the site;
    ``group_norm`` as a "gn" site; ``flash_attention_d<D>`` as the site, or
    in bf16 ``cross_attention`` (every key in one tile: the UNet's
    cross-attention to the text tokens); ``canny_prepare`` as a "canny" site
    and ``layer_norm`` as an "ln" site (Canny has no gate)."""
    if op == "conv":
        return _conv("conv3x3", key)
    if op == "resnet":
        n, h, w, cin, cout, groups, temb = key
        conv1 = _conv("conv3x3_fused", (n, h, w, cin, cout, temb, False))
        conv2 = _conv("conv3x3_fused", (n, h, w, cout, cout, False, True))
        if conv1 and conv2:
            return (_gn((n, h, w, cin, groups), "group_norm_scale_shift") + conv1
                    + _gn((n, h, w, cout, groups), "group_norm_scale_shift") + conv2)
        return (_gn((n, h, w, cin, groups, "silu")) + _conv("conv3x3", (n, h, w, cin, cout))
                + _gn((n, h, w, cout, groups, "silu")) + _conv("conv3x3", (n, h, w, cout, cout)))
    if op == "up2":
        n, h, w, cin, cout = key
        return _conv("conv3x3_up2", key) or _conv("conv3x3", (n, 2 * h, 2 * w, cin, cout))
    if op == "down2":
        return _conv("conv3x3_down2", key)
    if op == "gn":
        return _gn(key)
    if op == "attn":
        b, sq, skv, heads, d = key
        if flags.takes("flash_attention", (b, sq, heads, d), skv):
            return [(f"flash_attention_d{d}", key)]
        if flags.takes("cross_attention", (b, sq, heads, d), skv, dtype):
            return [("cross_attention", key)]
        return []
    if op == "canny":
        return [("canny_prepare", key)]
    if op == "ln":
        return [("layer_norm", key)] if flags.takes("layer_norm", key[-1], dtype) else []
    raise ValueError(f"unknown op {op!r}")


def stage_context(stage: str):
    """The stage a site runs in: ``flags.stage`` for the three model
    stages, none for prepare."""
    return flags.stage(stage) if stage in flags.STAGES else contextlib.nullcontext()


def kernel_calls(sites: Counter, dtype: torch.dtype = torch.bfloat16) -> Counter:
    """(kernel, shape key) -> calls, each site routed in its stage, for an
    edit in ``dtype``: the bf16 kernels, or their fp32 instances
    (``<kernel>_f32``)."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the kernels take bf16 or fp32, not {dtype}")
    suffix = F32_SUFFIX if dtype == torch.float32 else ""
    out = Counter()
    for (stage, op, key), c in sites.items():
        with stage_context(stage):
            for kernel, shape in route(op, key, dtype):
                out[(kernel + suffix, shape)] += c
    return out


def launches_by_kernel(calls: Counter) -> dict:
    """Kernel -> launches, for every kernel (zero where none)."""
    out = dict.fromkeys(KERNELS, 0)
    for (kernel, _), c in calls.items():
        out[kernel] += c
    return out


def launch_counts() -> dict:
    """Kernel -> the launches its wrapper has counted since the last reset
    (a graph's replay counts none: only eager calls and captures do)."""
    counts = {"conv3x3": conv3x3.launches, "conv3x3_f32": conv3x3.launches_f32,
              **conv_fused.launches,
              "group_norm": fused_groupnorm.launches,
              "group_norm_f32": fused_groupnorm.launches_f32,
              "group_norm_scale_shift": fused_groupnorm.scale_shift_launches,
              "group_norm_scale_shift_f32": fused_groupnorm.scale_shift_launches_f32,
              **{f"flash_attention_d{d}": n for d, n in fa.launches.items()},
              **{f"flash_attention_d{d}_f32": n for d, n in fa.launches_f32.items()},
              **canny.launches,
              "layer_norm": layer_norm.launches, "layer_norm_f32": layer_norm.launches_f32,
              "cross_attention": fa.cross_launches}
    return {k: counts[k] for k in KERNELS}


def reset_launch_counts() -> None:
    conv3x3.launches = conv3x3.launches_f32 = 0
    fused_groupnorm.launches = fused_groupnorm.launches_f32 = 0
    fused_groupnorm.scale_shift_launches = fused_groupnorm.scale_shift_launches_f32 = 0
    layer_norm.launches = layer_norm.launches_f32 = 0
    fa.cross_launches = 0
    for counts in (conv_fused.launches, fa.launches, fa.launches_f32, canny.launches):
        for k in counts:
            counts[k] = 0
