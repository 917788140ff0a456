"""HF/diffusers checkpoint tensor names -> the converted checkpoint's trees.

A copy of the JAX package's ``tools/hf_mapping.py`` on torch tensors: it
takes a flat ``{hf_key: torch.Tensor}`` state dict (as read from
safetensors, in any dtype, bf16 included) and produces the nested parameter
tree of the JAX package's modules, whose flattened paths are the keys of a
converted checkpoint (``utils/checkpoint.py``).  Both packages read that one
layout; the port's modules take it back to diffusers names through
``tools/from_jax.py``.  Used by ``tools/convert_checkpoint.py``.

Layout conversions:
  * torch Linear weight [out, in]  -> Flax Dense kernel [in, out] (transpose)
  * torch Conv2d weight [O, I, kh, kw] -> Flax Conv kernel [kh, kw, I, O]
  * norms: weight -> scale, bias -> bias
  * homogeneous layer stacks (CLIP encoder layers, transformer blocks, DINO
    blocks) are scanned in the JAX package's models, so their per-layer HF
    tensors are STACKED along a new leading axis under a single module
    ("layers/layer", "transformer_blocks/block", "blocks/block").
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from fastedit_tpu_torch.models.configs import (
    CLIPTextConfig,
    CLIPVisionConfig,
    ControlNetConfig,
    UNetConfig,
    VAEConfig,
)

Params = Dict[str, Any]


class MappingError(KeyError):
    pass


def _finish(sd: "_SD", strict: bool, allow: tuple = ()) -> None:
    """Completeness gate: with ``strict`` every checkpoint tensor must have
    been consumed (modulo an explicit allowlist of known-harmless extras,
    e.g. non-persistent transformers buffers)."""
    if not strict:
        return
    import fnmatch

    leftover = [
        k
        for k in sd.unused()
        if not any(fnmatch.fnmatch(k, pat) for pat in allow)
    ]
    if leftover:
        raise MappingError(
            f"{len(leftover)} unconsumed checkpoint tensors "
            f"(converter/key-layout mismatch), e.g. {leftover[:8]}"
        )


# transformers buffers that may or may not be serialized depending on the
# library version; never weights.
_CLIP_ALLOWED_UNUSED = ("*position_ids",)


class _SD:
    """State-dict view that tracks consumed keys (completeness checking)."""

    def __init__(self, sd: Dict[str, torch.Tensor], prefix: str = ""):
        self.sd = sd
        self.prefix = prefix
        self.used: set[str] = set()

    def scoped(self, prefix: str) -> "_SD":
        child = _SD(self.sd, self.prefix + prefix)
        child.used = self.used  # share the consumption ledger
        return child

    def take(self, key: str) -> torch.Tensor:
        full = self.prefix + key
        if full not in self.sd:
            raise MappingError(f"missing checkpoint tensor: {full}")
        self.used.add(full)
        return self.sd[full]

    def has(self, key: str) -> bool:
        return self.prefix + key in self.sd

    def unused(self) -> list[str]:
        return sorted(k for k in self.sd if k not in self.used)


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.t().contiguous()


def stack_layer_trees(trees: list) -> Params:
    """Stack identical per-layer param trees along a new leading axis."""
    assert trees
    out: Params = {}
    for k, v in trees[0].items():
        if isinstance(v, dict):
            out[k] = stack_layer_trees([t[k] for t in trees])
        else:
            out[k] = torch.stack([t[k] for t in trees])
    return out


def _conv(x: torch.Tensor) -> torch.Tensor:
    return x.permute(2, 3, 1, 0).contiguous()


def _dense(sd: _SD, key: str, bias: bool = True) -> Params:
    p = {"kernel": _t(sd.take(f"{key}.weight"))}
    if bias and sd.has(f"{key}.bias"):
        p["bias"] = sd.take(f"{key}.bias")
    return p


def _conv2d(sd: _SD, key: str) -> Params:
    return {"kernel": _conv(sd.take(f"{key}.weight")), "bias": sd.take(f"{key}.bias")}


def _norm(sd: _SD, key: str) -> Params:
    return {"scale": sd.take(f"{key}.weight"), "bias": sd.take(f"{key}.bias")}


# --------------------------------------------------------------------------
# CLIP text tower (transformers CLIPTextModel[WithProjection] state dict)
# --------------------------------------------------------------------------


def convert_clip_text(
    sd_dict: Dict[str, torch.Tensor], cfg: CLIPTextConfig, strict: bool = False
) -> Params:
    sd = _SD(sd_dict)
    tm = sd.scoped("text_model.")
    params: Params = {
        "token_embedding": {
            "embedding": tm.take("embeddings.token_embedding.weight")
        },
        "position_embedding": tm.take("embeddings.position_embedding.weight"),
        "final_layer_norm": _norm(tm, "final_layer_norm"),
        "layers": _clip_encoder_layers(tm, cfg.num_layers, "encoder"),
    }
    if cfg.projection_dim is not None:
        params["text_projection"] = _dense(sd, "text_projection", bias=False)
    # a combined CLIPModel dump also carries the vision tower + logit_scale
    _finish(sd, strict, _CLIP_ALLOWED_UNUSED + ("vision_model.*", "visual_projection.*", "logit_scale"))
    return params


def _clip_encoder_layers(tm: _SD, num_layers: int, prefix: str) -> Params:
    """Per-layer HF tensors stacked for the scanned layer stack."""
    per_layer = []
    for i in range(num_layers):
        layer = tm.scoped(f"{prefix}.layers.{i}.")
        per_layer.append(
            {
                "layer_norm1": _norm(layer, "layer_norm1"),
                "layer_norm2": _norm(layer, "layer_norm2"),
                "self_attn": {
                    "q_proj": _dense(layer, "self_attn.q_proj"),
                    "k_proj": _dense(layer, "self_attn.k_proj"),
                    "v_proj": _dense(layer, "self_attn.v_proj"),
                    "out_proj": _dense(layer, "self_attn.out_proj"),
                },
                "mlp_fc1": _dense(layer, "mlp.fc1"),
                "mlp_fc2": _dense(layer, "mlp.fc2"),
            }
        )
    return {"layer": stack_layer_trees(per_layer)}


def convert_clip_vision(
    sd_dict: Dict[str, torch.Tensor], cfg: CLIPVisionConfig, strict: bool = False
) -> Params:
    """transformers CLIPVisionModelWithProjection (or the vision half of
    CLIPModel) -> our CLIPVisionModel params."""
    sd = _SD(sd_dict)
    vm = sd.scoped("vision_model.")
    params = {
        "patch_embedding": {
            "kernel": _conv(vm.take("embeddings.patch_embedding.weight"))
        },
        "class_embedding": vm.take("embeddings.class_embedding"),
        "position_embedding": vm.take("embeddings.position_embedding.weight"),
        "pre_layrnorm": _norm(vm, "pre_layrnorm"),
        "post_layernorm": _norm(vm, "post_layernorm"),
        "visual_projection": _dense(sd, "visual_projection", bias=False),
        "layers": _clip_encoder_layers(vm, cfg.num_layers, "encoder"),
    }
    _finish(sd, strict, _CLIP_ALLOWED_UNUSED + ("text_model.*", "text_projection.*", "logit_scale"))
    return params


def convert_dino_vit(
    sd_dict: Dict[str, torch.Tensor], num_layers: int, strict: bool = False
) -> Params:
    """facebookresearch/dino ViT (timm-style names) -> our DINOViT params."""
    sd = _SD(sd_dict)
    params: Params = {
        "patch_embed": _conv2d(sd, "patch_embed.proj"),
        "cls_token": sd.take("cls_token"),  # [1, 1, D]
        "pos_embed": sd.take("pos_embed"),  # [1, N+1, D]
    }
    per_layer = []
    for i in range(num_layers):
        b = sd.scoped(f"blocks.{i}.")
        per_layer.append(
            {
                "norm1": _norm(b, "norm1"),
                "qkv": _dense(b, "attn.qkv"),
                "proj": _dense(b, "attn.proj"),
                "norm2": _norm(b, "norm2"),
                "fc1": _dense(b, "mlp.fc1"),
                "fc2": _dense(b, "mlp.fc2"),
            }
        )
    params["blocks"] = {"block": stack_layer_trees(per_layer)}
    # The checkpoint's final LayerNorm ("norm.*") is consumed but dropped:
    # the DINO distance metric reads layer-11 attention keys only
    # (reference src/metrics.py:89-111), so DINOViT has no final norm.
    if sd.has("norm.weight"):
        _norm(sd, "norm")
    _finish(sd, strict)
    return params


# SqueezeNet 1.1 torchvision feature indices -> our module names.
_SQUEEZE_FIRES = {
    3: "fire3", 4: "fire4", 6: "fire6", 7: "fire7",
    9: "fire9", 10: "fire10", 11: "fire11", 12: "fire12",
}


def convert_lpips_squeeze(
    backbone_sd: Dict[str, torch.Tensor],
    heads_sd: Dict[str, torch.Tensor],
    strict: bool = False,
) -> Params:
    """torchvision squeezenet1_1 features + LPIPS 1x1 linear heads -> LPIPS
    params.  ``heads_sd`` keys: lin{0..6}.model.1.weight (lpips package) or
    lins.{i}.model.1.weight (torchmetrics)."""
    sd = _SD(backbone_sd)
    net: Params = {"conv1": _conv2d(sd, "features.0")}
    for idx, name in _SQUEEZE_FIRES.items():
        f = sd.scoped(f"features.{idx}.")
        net[name] = {
            "squeeze": _conv2d(f, "squeeze"),
            "expand1x1": _conv2d(f, "expand1x1"),
            "expand3x3": _conv2d(f, "expand3x3"),
        }
    params: Params = {"net": net}
    for i in range(7):
        for key in (
            f"lin{i}.model.1.weight",
            f"lins.{i}.model.1.weight",
            f"net.lin{i}.model.1.weight",
        ):
            if key in heads_sd:
                params[f"lin{i}"] = {"kernel": _conv(heads_sd[key])}
                break
        else:
            raise MappingError(f"LPIPS head lin{i} not found in heads state dict")
    # a full squeezenet1_1 dump also carries its (unused) 1000-class head
    _finish(sd, strict, ("classifier.*",))
    return params


# --------------------------------------------------------------------------
# Shared UNet-family pieces (diffusers UNet2DConditionModel / ControlNetModel)
# --------------------------------------------------------------------------


def _resnet(sd: _SD, key: str, time_emb: bool = True) -> Params:
    r = sd.scoped(key + ".")
    p = {
        "norm1": _norm(r, "norm1"),
        "conv1": _conv2d(r, "conv1"),
        "norm2": _norm(r, "norm2"),
        "conv2": _conv2d(r, "conv2"),
    }
    if time_emb and r.has("time_emb_proj.weight"):
        p["time_emb_proj"] = _dense(r, "time_emb_proj")
    if r.has("conv_shortcut.weight"):
        p["conv_shortcut"] = _conv2d(r, "conv_shortcut")
    return p


def _attention_inner(sd: _SD, key: str) -> Params:
    a = sd.scoped(key + ".")
    return {
        "to_q": _dense(a, "to_q"),
        "to_k": _dense(a, "to_k"),
        "to_v": _dense(a, "to_v"),
        "to_out": _dense(a, "to_out.0"),
    }


def _transformer_block(sd: _SD, key: str) -> Params:
    b = sd.scoped(key + ".")
    return {
        "norm1": _norm(b, "norm1"),
        "attn1": _attention_inner(b, "attn1"),
        "norm2": _norm(b, "norm2"),
        "attn2": _attention_inner(b, "attn2"),
        "norm3": _norm(b, "norm3"),
        "ff": {
            "net_0_proj": _dense(b, "ff.net.0.proj"),
            "net_2": _dense(b, "ff.net.2"),
        },
    }


def _transformer2d(sd: _SD, key: str, depth: int) -> Params:
    t = sd.scoped(key + ".")
    blocks = [
        _transformer_block(t, f"transformer_blocks.{k}") for k in range(depth)
    ]
    return {
        "norm": _norm(t, "norm"),
        "proj_in": _dense(t, "proj_in"),
        "proj_out": _dense(t, "proj_out"),
        "transformer_blocks": {"block": stack_layer_trees(blocks)},
    }


def _cond_embedder(sd: _SD) -> Params:
    return {
        "time_embedding": {
            "linear_1": _dense(sd, "time_embedding.linear_1"),
            "linear_2": _dense(sd, "time_embedding.linear_2"),
        },
        "add_embedding": {
            "linear_1": _dense(sd, "add_embedding.linear_1"),
            "linear_2": _dense(sd, "add_embedding.linear_2"),
        },
    }


def _down_blocks(sd: _SD, cfg: UNetConfig) -> Params:
    out: Params = {}
    n = len(cfg.block_out_channels)
    for i in range(n):
        blk = sd.scoped(f"down_blocks.{i}.")
        p: Params = {}
        for j, depth in enumerate(cfg.down_transformer_layers[i]):
            p[f"resnets_{j}"] = _resnet(blk, f"resnets.{j}")
            if depth > 0:
                p[f"attentions_{j}"] = _transformer2d(blk, f"attentions.{j}", depth)
        if i < n - 1:
            p["downsamplers_0"] = {"conv": _conv2d(blk, "downsamplers.0.conv")}
        out[f"down_blocks_{i}"] = p
    return out


def _mid_block(sd: _SD, cfg: UNetConfig) -> Params:
    blk = sd.scoped("mid_block.")
    p: Params = {
        "resnets_0": _resnet(blk, "resnets.0"),
        "resnets_1": _resnet(blk, "resnets.1"),
    }
    if cfg.mid_transformer_layers and cfg.mid_transformer_layers > 0:
        p["attentions_0"] = _transformer2d(
            blk, "attentions.0", cfg.mid_transformer_layers
        )
    return p


def convert_unet(
    sd_dict: Dict[str, torch.Tensor], cfg: UNetConfig, strict: bool = False
) -> Params:
    sd = _SD(sd_dict)
    params: Params = {
        "conv_in": _conv2d(sd, "conv_in"),
        "cond_embedder": _cond_embedder(sd),
        "conv_norm_out": _norm(sd, "conv_norm_out"),
        "conv_out": _conv2d(sd, "conv_out"),
    }
    params.update(_down_blocks(sd, cfg))
    if cfg.mid_transformer_layers is not None:
        params["mid_block"] = _mid_block(sd, cfg)
    for i in range(len(cfg.block_out_channels)):
        blk = sd.scoped(f"up_blocks.{i}.")
        p: Params = {}
        for j, depth in enumerate(cfg.up_transformer_layers[i]):
            p[f"resnets_{j}"] = _resnet(blk, f"resnets.{j}")
            if depth > 0:
                p[f"attentions_{j}"] = _transformer2d(blk, f"attentions.{j}", depth)
        if i < len(cfg.block_out_channels) - 1:
            p["upsamplers_0"] = {"conv": _conv2d(blk, "upsamplers.0.conv")}
        params[f"up_blocks_{i}"] = p
    _finish(sd, strict)
    return params


def convert_controlnet(
    sd_dict: Dict[str, torch.Tensor], cfg: ControlNetConfig, strict: bool = False
) -> Params:
    sd = _SD(sd_dict)
    ucfg = cfg.unet
    params: Params = {
        "conv_in": _conv2d(sd, "conv_in"),
        "cond_embedder": _cond_embedder(sd),
    }
    params.update(_down_blocks(sd, ucfg))
    if ucfg.mid_transformer_layers is not None:
        params["mid_block"] = _mid_block(sd, ucfg)

    emb = sd.scoped("controlnet_cond_embedding.")
    cond: Params = {
        "conv_in": _conv2d(emb, "conv_in"),
        "conv_out": _conv2d(emb, "conv_out"),
    }
    n_blocks = 2 * (len(cfg.conditioning_embedding_channels) - 1)
    for k in range(n_blocks):
        cond[f"blocks_{k}"] = _conv2d(emb, f"blocks.{k}")
    params["controlnet_cond_embedding"] = cond

    i = 0
    while sd.has(f"controlnet_down_blocks.{i}.weight"):
        params[f"controlnet_down_blocks_{i}"] = _conv2d(
            sd, f"controlnet_down_blocks.{i}"
        )
        i += 1
    params["controlnet_mid_block"] = _conv2d(sd, "controlnet_mid_block")
    _finish(sd, strict)
    return params


# --------------------------------------------------------------------------
# VAE (diffusers AutoencoderKL)
# --------------------------------------------------------------------------


def _vae_attention(sd: _SD, key: str) -> Params:
    a = sd.scoped(key + ".")
    if a.has("to_q.weight"):  # modern naming
        qkv = {
            "to_q": _dense(a, "to_q"),
            "to_k": _dense(a, "to_k"),
            "to_v": _dense(a, "to_v"),
            "to_out": _dense(a, "to_out.0"),
        }
        gn = _norm(a, "group_norm")
    else:  # legacy naming (query/key/value/proj_attn)
        qkv = {
            "to_q": _dense(a, "query"),
            "to_k": _dense(a, "key"),
            "to_v": _dense(a, "value"),
            "to_out": _dense(a, "proj_attn"),
        }
        gn = _norm(a, "group_norm")
    return {"group_norm": gn, "attention": qkv}


def _vae_mid(sd: _SD) -> Params:
    blk = sd.scoped("mid_block.")
    return {
        "resnets_0": _resnet(blk, "resnets.0", time_emb=False),
        "attentions_0": _vae_attention(blk, "attentions.0"),
        "resnets_1": _resnet(blk, "resnets.1", time_emb=False),
    }


def convert_vae(
    sd_dict: Dict[str, torch.Tensor], cfg: VAEConfig, strict: bool = False
) -> Params:
    sd = _SD(sd_dict)
    n = len(cfg.block_out_channels)

    enc = sd.scoped("encoder.")
    encoder: Params = {
        "conv_in": _conv2d(enc, "conv_in"),
        "mid_block": _vae_mid(enc),
        "conv_norm_out": _norm(enc, "conv_norm_out"),
        "conv_out": _conv2d(enc, "conv_out"),
    }
    for i in range(n):
        for j in range(cfg.layers_per_block):
            encoder[f"down_blocks_{i}_resnets_{j}"] = _resnet(
                enc, f"down_blocks.{i}.resnets.{j}", time_emb=False
            )
        if i < n - 1:
            encoder[f"down_blocks_{i}_downsamplers_0"] = {
                "conv": _conv2d(enc, f"down_blocks.{i}.downsamplers.0.conv")
            }

    dec = sd.scoped("decoder.")
    decoder: Params = {
        "conv_in": _conv2d(dec, "conv_in"),
        "mid_block": _vae_mid(dec),
        "conv_norm_out": _norm(dec, "conv_norm_out"),
        "conv_out": _conv2d(dec, "conv_out"),
    }
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            decoder[f"up_blocks_{i}_resnets_{j}"] = _resnet(
                dec, f"up_blocks.{i}.resnets.{j}", time_emb=False
            )
        if i < n - 1:
            decoder[f"up_blocks_{i}_upsamplers_0"] = {
                "conv": _conv2d(dec, f"up_blocks.{i}.upsamplers.0.conv")
            }

    params = {
        "encoder": encoder,
        "decoder": decoder,
        "quant_conv": _conv2d(sd, "quant_conv"),
        "post_quant_conv": _conv2d(sd, "post_quant_conv"),
    }
    _finish(sd, strict)
    return params
