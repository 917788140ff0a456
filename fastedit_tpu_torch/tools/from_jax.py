"""The JAX package's parameter trees as this package's state dicts.

Input: a nested dict with the JAX package's parameter names: numpy arrays
(Flax trees from ``init``, moved to the host with ``np.asarray``; taken as
fp32), or torch tensors in any dtype (a converted checkpoint read by
``utils/checkpoint.load_params``; kept in their dtype).  Output: a flat
``{name: torch.Tensor}`` state dict with diffusers (transformers, timm,
torchvision) names for ``load_state_dict``.  This is the inverse of
``tools/hf_mapping.convert_*``:

  * conv kernel HWIO [kh, kw, I, O] -> weight OIHW [O, I, kh, kw];
  * dense kernel [in, out] -> Linear weight [out, in];
  * norm scale/bias -> weight/bias;
  * scanned layer stacks (``transformer_blocks/block``, ``layers/layer``)
    stacked on a leading axis -> one entry per layer.

Pure numpy and torch: nothing here imports JAX.  State dicts: the edit's
models (UNet, ControlNet, VAE, CLIP text towers) and the metrics' backbones
(CLIP vision, DINO ViT, LPIPS-Squeeze).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from fastedit_tpu_torch.models.configs import (
    CLIPTextConfig,
    CLIPVisionConfig,
    ControlNetConfig,
    UNetConfig,
    VAEConfig,
)

Tree = Dict[str, Any]


def _tensor(x) -> torch.Tensor:
    """A torch tensor as it is; a numpy array as an fp32 copy."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x, dtype=np.float32))


class _Out(dict):
    def put(self, key: str, arr) -> None:
        if key in self:
            raise KeyError(f"duplicate state-dict key {key}")
        self[key] = _tensor(arr).contiguous()


def _conv(out: _Out, p: Tree, key: str) -> None:
    out.put(f"{key}.weight", _tensor(p["kernel"]).permute(3, 2, 0, 1))
    if "bias" in p:
        out.put(f"{key}.bias", p["bias"])


def _dense(out: _Out, p: Tree, key: str) -> None:
    out.put(f"{key}.weight", _tensor(p["kernel"]).t())
    if "bias" in p:
        out.put(f"{key}.bias", p["bias"])


def _norm(out: _Out, p: Tree, key: str) -> None:
    out.put(f"{key}.weight", p["scale"])
    out.put(f"{key}.bias", p["bias"])


def _unstack(tree: Tree, n: int) -> list:
    """Split a stacked layer tree into ``n`` per-layer trees."""
    def split(t):
        return {k: split(v) if isinstance(v, dict) else _tensor(v).unbind(0)
                for k, v in t.items()}

    def take(t, i):
        return {k: take(v, i) if isinstance(v, dict) else v[i] for k, v in t.items()}
    parts = split(tree)
    return [take(parts, i) for i in range(n)]


def _resnet(out: _Out, p: Tree, key: str) -> None:
    _norm(out, p["norm1"], f"{key}.norm1")
    _conv(out, p["conv1"], f"{key}.conv1")
    _norm(out, p["norm2"], f"{key}.norm2")
    _conv(out, p["conv2"], f"{key}.conv2")
    if "time_emb_proj" in p:
        _dense(out, p["time_emb_proj"], f"{key}.time_emb_proj")
    if "conv_shortcut" in p:
        _conv(out, p["conv_shortcut"], f"{key}.conv_shortcut")


def _attention_inner(out: _Out, p: Tree, key: str) -> None:
    for name in ("to_q", "to_k", "to_v"):
        _dense(out, p[name], f"{key}.{name}")
    _dense(out, p["to_out"], f"{key}.to_out.0")


def _transformer2d(out: _Out, p: Tree, key: str, depth: int) -> None:
    _norm(out, p["norm"], f"{key}.norm")
    _dense(out, p["proj_in"], f"{key}.proj_in")
    _dense(out, p["proj_out"], f"{key}.proj_out")
    for k, b in enumerate(_unstack(p["transformer_blocks"]["block"], depth)):
        bk = f"{key}.transformer_blocks.{k}"
        for n in ("norm1", "norm2", "norm3"):
            _norm(out, b[n], f"{bk}.{n}")
        _attention_inner(out, b["attn1"], f"{bk}.attn1")
        _attention_inner(out, b["attn2"], f"{bk}.attn2")
        _dense(out, b["ff"]["net_0_proj"], f"{bk}.ff.net.0.proj")
        _dense(out, b["ff"]["net_2"], f"{bk}.ff.net.2")


def _cond_embedder(out: _Out, p: Tree) -> None:
    for emb in ("time_embedding", "add_embedding"):
        for lin in ("linear_1", "linear_2"):
            _dense(out, p[emb][lin], f"{emb}.{lin}")


def _down_blocks(out: _Out, p: Tree, cfg: UNetConfig) -> None:
    n = len(cfg.block_out_channels)
    for i in range(n):
        blk = p[f"down_blocks_{i}"]
        for j, depth in enumerate(cfg.down_transformer_layers[i]):
            _resnet(out, blk[f"resnets_{j}"], f"down_blocks.{i}.resnets.{j}")
            if depth > 0:
                _transformer2d(out, blk[f"attentions_{j}"], f"down_blocks.{i}.attentions.{j}", depth)
        if i < n - 1:
            _conv(out, blk["downsamplers_0"]["conv"], f"down_blocks.{i}.downsamplers.0.conv")


def _mid_block(out: _Out, p: Tree, cfg: UNetConfig) -> None:
    blk = p["mid_block"]
    _resnet(out, blk["resnets_0"], "mid_block.resnets.0")
    _resnet(out, blk["resnets_1"], "mid_block.resnets.1")
    if cfg.mid_transformer_layers:
        _transformer2d(out, blk["attentions_0"], "mid_block.attentions.0",
                       cfg.mid_transformer_layers)


def unet_state_dict(params: Tree, cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    out = _Out()
    _conv(out, params["conv_in"], "conv_in")
    _cond_embedder(out, params["cond_embedder"])
    _norm(out, params["conv_norm_out"], "conv_norm_out")
    _conv(out, params["conv_out"], "conv_out")
    _down_blocks(out, params, cfg)
    if cfg.mid_transformer_layers is not None:
        _mid_block(out, params, cfg)
    n = len(cfg.block_out_channels)
    for i in range(n):
        blk = params[f"up_blocks_{i}"]
        for j, depth in enumerate(cfg.up_transformer_layers[i]):
            _resnet(out, blk[f"resnets_{j}"], f"up_blocks.{i}.resnets.{j}")
            if depth > 0:
                _transformer2d(out, blk[f"attentions_{j}"], f"up_blocks.{i}.attentions.{j}", depth)
        if i < n - 1:
            _conv(out, blk["upsamplers_0"]["conv"], f"up_blocks.{i}.upsamplers.0.conv")
    return dict(out)


def controlnet_state_dict(params: Tree, cfg: ControlNetConfig) -> Dict[str, torch.Tensor]:
    out = _Out()
    ucfg = cfg.unet
    _conv(out, params["conv_in"], "conv_in")
    _cond_embedder(out, params["cond_embedder"])
    _down_blocks(out, params, ucfg)
    if ucfg.mid_transformer_layers is not None:
        _mid_block(out, params, ucfg)
    emb = params["controlnet_cond_embedding"]
    _conv(out, emb["conv_in"], "controlnet_cond_embedding.conv_in")
    _conv(out, emb["conv_out"], "controlnet_cond_embedding.conv_out")
    for k in range(2 * (len(cfg.conditioning_embedding_channels) - 1)):
        _conv(out, emb[f"blocks_{k}"], f"controlnet_cond_embedding.blocks.{k}")
    i = 0
    while f"controlnet_down_blocks_{i}" in params:
        _conv(out, params[f"controlnet_down_blocks_{i}"], f"controlnet_down_blocks.{i}")
        i += 1
    _conv(out, params["controlnet_mid_block"], "controlnet_mid_block")
    return dict(out)


def _vae_mid(out: _Out, p: Tree, key: str) -> None:
    _resnet(out, p["resnets_0"], f"{key}.resnets.0")
    _resnet(out, p["resnets_1"], f"{key}.resnets.1")
    att = p["attentions_0"]
    _norm(out, att["group_norm"], f"{key}.attentions.0.group_norm")
    _attention_inner(out, att["attention"], f"{key}.attentions.0")


def vae_state_dict(params: Tree, cfg: VAEConfig) -> Dict[str, torch.Tensor]:
    out = _Out()
    n = len(cfg.block_out_channels)
    enc = params["encoder"]
    _conv(out, enc["conv_in"], "encoder.conv_in")
    _vae_mid(out, enc["mid_block"], "encoder.mid_block")
    _norm(out, enc["conv_norm_out"], "encoder.conv_norm_out")
    _conv(out, enc["conv_out"], "encoder.conv_out")
    for i in range(n):
        for j in range(cfg.layers_per_block):
            _resnet(out, enc[f"down_blocks_{i}_resnets_{j}"], f"encoder.down_blocks.{i}.resnets.{j}")
        if i < n - 1:
            _conv(out, enc[f"down_blocks_{i}_downsamplers_0"]["conv"],
                  f"encoder.down_blocks.{i}.downsamplers.0.conv")
    dec = params["decoder"]
    _conv(out, dec["conv_in"], "decoder.conv_in")
    _vae_mid(out, dec["mid_block"], "decoder.mid_block")
    _norm(out, dec["conv_norm_out"], "decoder.conv_norm_out")
    _conv(out, dec["conv_out"], "decoder.conv_out")
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            _resnet(out, dec[f"up_blocks_{i}_resnets_{j}"], f"decoder.up_blocks.{i}.resnets.{j}")
        if i < n - 1:
            _conv(out, dec[f"up_blocks_{i}_upsamplers_0"]["conv"],
                  f"decoder.up_blocks.{i}.upsamplers.0.conv")
    _conv(out, params["quant_conv"], "quant_conv")
    _conv(out, params["post_quant_conv"], "post_quant_conv")
    return dict(out)


def _clip_layers(out: _Out, p: Tree, n: int, prefix: str) -> None:
    for i, layer in enumerate(_unstack(p["layer"], n)):
        key = f"{prefix}.encoder.layers.{i}"
        _norm(out, layer["layer_norm1"], f"{key}.layer_norm1")
        _norm(out, layer["layer_norm2"], f"{key}.layer_norm2")
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(out, layer["self_attn"][name], f"{key}.self_attn.{name}")
        _dense(out, layer["mlp_fc1"], f"{key}.mlp.fc1")
        _dense(out, layer["mlp_fc2"], f"{key}.mlp.fc2")


def clip_text_state_dict(params: Tree, cfg: CLIPTextConfig) -> Dict[str, torch.Tensor]:
    out = _Out()
    out.put("text_model.embeddings.token_embedding.weight",
            params["token_embedding"]["embedding"])
    out.put("text_model.embeddings.position_embedding.weight", params["position_embedding"])
    _norm(out, params["final_layer_norm"], "text_model.final_layer_norm")
    _clip_layers(out, params["layers"], cfg.num_layers, "text_model")
    if cfg.projection_dim is not None:
        _dense(out, params["text_projection"], "text_projection")
    return dict(out)


def clip_vision_state_dict(params: Tree, cfg: CLIPVisionConfig) -> Dict[str, torch.Tensor]:
    out = _Out()
    emb = "vision_model.embeddings"
    _conv(out, params["patch_embedding"], f"{emb}.patch_embedding")
    out.put(f"{emb}.class_embedding", params["class_embedding"])
    out.put(f"{emb}.position_embedding.weight", params["position_embedding"])
    _norm(out, params["pre_layrnorm"], "vision_model.pre_layrnorm")
    _norm(out, params["post_layernorm"], "vision_model.post_layernorm")
    _clip_layers(out, params["layers"], cfg.num_layers, "vision_model")
    _dense(out, params["visual_projection"], "visual_projection")
    return dict(out)


def dino_state_dict(params: Tree, num_layers: int) -> Dict[str, torch.Tensor]:
    """DINO ViT (timm names; the JAX model has no final norm)."""
    out = _Out()
    _conv(out, params["patch_embed"], "patch_embed.proj")
    out.put("cls_token", params["cls_token"])
    out.put("pos_embed", params["pos_embed"])
    for i, b in enumerate(_unstack(params["blocks"]["block"], num_layers)):
        _norm(out, b["norm1"], f"blocks.{i}.norm1")
        _dense(out, b["qkv"], f"blocks.{i}.attn.qkv")
        _dense(out, b["proj"], f"blocks.{i}.attn.proj")
        _norm(out, b["norm2"], f"blocks.{i}.norm2")
        _dense(out, b["fc1"], f"blocks.{i}.mlp.fc1")
        _dense(out, b["fc2"], f"blocks.{i}.mlp.fc2")
    return dict(out)


# SqueezeNet 1.1 torchvision feature indices of the JAX module names.
SQUEEZE_FIRES = {"fire3": 3, "fire4": 4, "fire6": 6, "fire7": 7, "fire9": 9, "fire10": 10,
                 "fire11": 11, "fire12": 12}


def lpips_state_dict(params: Tree) -> Dict[str, torch.Tensor]:
    """LPIPS-Squeeze: torchvision ``squeezenet1_1`` feature names under
    ``net.`` and the lpips package's heads ``lin{i}.model.1``."""
    out = _Out()
    net = params["net"]
    _conv(out, net["conv1"], "net.features.0")
    for name, idx in SQUEEZE_FIRES.items():
        for part in ("squeeze", "expand1x1", "expand3x3"):
            _conv(out, net[name][part], f"net.features.{idx}.{part}")
    for i in range(7):
        _conv(out, params[f"lin{i}"], f"lin{i}.model.1")
    return dict(out)
