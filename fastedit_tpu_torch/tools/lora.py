"""Offline LCM-LoRA fusion: merge low-rank adapters into dense UNet weights
(the port's copy of the JAX package's ``tools/lora.py``, on torch state dicts).

The reference applies LCM-LoRA at runtime through peft
(src/pipeline.py:154).  Here, as in the JAX package, W' = W + scale *
(up @ down) is fused once at checkpoint-conversion time, so inference runs
dense bf16 weights with no LoRA math.  The delta and the sum are fp32 numpy,
the same operations as the JAX package's, so both fuse the same bits; the
result is cast back to W's dtype with torch (bf16 has no numpy dtype here).

Handles the common serialization dialects of SDXL LoRA checkpoints:
  * peft:      <module>.lora_A.weight / <module>.lora_B.weight
  * diffusers: <module>.lora.down.weight / <module>.lora.up.weight
               (also lora_linear_layer.down/up)
  * kohya:     lora_unet_<module with _>.lora_down.weight / .lora_up.weight
               + optional per-module ``alpha`` scalars.

Scaling: alpha/rank when an alpha is stored, else 1.0 (diffusers' fuse
default for rank-embedded checkpoints).
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch


_DIALECTS = (
    ("lora_A.weight", "lora_B.weight"),
    ("lora.down.weight", "lora.up.weight"),
    ("lora_linear_layer.down.weight", "lora_linear_layer.up.weight"),
    ("lora_down.weight", "lora_up.weight"),
)


def _kohya_to_diffusers(module: str) -> str:
    """lora_unet_down_blocks_1_attentions_0_... -> down_blocks.1.attentions.0..."""
    module = re.sub(r"^lora_unet_", "", module)
    parts = module.split("_")
    out = []
    for p in parts:
        if p.isdigit() and out:
            out[-1] += "." + p
        else:
            out.append(p)
    joined = out[0]
    for s in out[1:]:
        joined += ("." if joined[-1].isdigit() else "_") + s
    # module paths are dot-separated in diffusers; heuristically convert the
    # known container names
    for name in (
        "down_blocks",
        "up_blocks",
        "mid_block",
        "attentions",
        "resnets",
        "transformer_blocks",
        "attn1",
        "attn2",
        "ff",
        "proj_in",
        "proj_out",
        "time_emb_proj",
    ):
        joined = joined.replace("_" + name, "." + name)
    return joined


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def extract_lora_pairs(
    lora_sd: Dict[str, torch.Tensor],
) -> Dict[str, Tuple[np.ndarray, np.ndarray, float]]:
    """-> {base_module_key: (down [r, in], up [out, r], scale)}, fp32 numpy."""
    pairs: Dict[str, Tuple[np.ndarray, np.ndarray, float]] = {}
    alphas = {
        k[: -len(".alpha")]: float(v)
        for k, v in lora_sd.items()
        if k.endswith(".alpha")
    }
    for key in lora_sd:
        for down_sfx, up_sfx in _DIALECTS:
            if key.endswith("." + down_sfx):
                module = key[: -len(down_sfx) - 1]
                up_key = f"{module}.{up_sfx}"
                if up_key not in lora_sd:
                    continue
                down = _f32(lora_sd[key])
                up = _f32(lora_sd[up_key])
                rank = down.shape[0]
                scale = alphas.get(module, float(rank)) / float(rank)
                base = module
                if base.startswith("unet."):
                    base = base[len("unet."):]
                if base.startswith("lora_unet_"):  # kohya dialect
                    base = _kohya_to_diffusers(base)
                pairs[base] = (down, up, scale)
                break
    return pairs


def fuse_lora_into_state_dict(
    base_sd: Dict[str, torch.Tensor],
    lora_sd: Dict[str, torch.Tensor],
    strict: bool = True,
) -> Tuple[Dict[str, torch.Tensor], int]:
    """Return (fused HF-layout state dict, number of fused modules).

    Works on the *HF/torch* layout (weight [out, in]) before our layout
    conversion, so the delta is simply up @ down.
    """
    fused = dict(base_sd)
    count = 0
    misses = []
    for module, (down, up, scale) in extract_lora_pairs(lora_sd).items():
        wkey = f"{module}.weight"
        if wkey not in fused:
            misses.append(module)
            continue
        w = _f32(fused[wkey])
        delta = scale * (up @ down)
        if w.ndim == 4:  # conv LoRA stored as [out, in] on 1x1
            delta = delta.reshape(w.shape)
        assert delta.shape == w.shape, (module, delta.shape, w.shape)
        fused[wkey] = torch.from_numpy(w + delta).to(base_sd[wkey].dtype)
        count += 1
    if misses and strict:
        raise KeyError(
            f"{len(misses)} LoRA modules not found in base state dict, e.g. "
            f"{misses[:5]}"
        )
    return fused, count
