"""Offline checkpoint converter: HF snapshots -> converted checkpoints.

The port's counterpart of the JAX package's ``tools/convert_checkpoint.py``:
the same kinds, flags and output layout (``utils/checkpoint.py``), so a
directory written by either converter is read by both packages.  It replaces
the reference's runtime HF-Hub downloads (src/pipeline.py:82-154) with a
one-time conversion to bf16 (or fp16, fp32) safetensors.  It needs neither
``safetensors`` nor ``ml_dtypes`` (``utils/safetensors_io.py``).

Run it where the HF snapshots are on disk; nothing here downloads.  Weight
sources per model (the reference's repos):

  ssd-1b:  unet   <- latent-consistency/lcm-ssd-1b        (full LCM UNet)
           others <- segmind/SSD-1B (text encoders, tokenizers)
  sdxl:    unet   <- stabilityai/stable-diffusion-xl-base-1.0
                     ⊕ latent-consistency/lcm-lora-sdxl   (fused offline)
  both:    vae    <- madebyollin/sdxl-vae-fp16-fix (bf16) or
                     stabilityai/sdxl-vae (fp32 parity runs)
           controlnet <- diffusers/controlnet-canny-sdxl-1.0-small (+ full)
  metrics: openai/clip-vit-base-patch16, torchvision squeezenet1_1 +
           LPIPS linear heads, facebookresearch/dino dino_vitb8.

Usage:
    python -m fastedit_tpu_torch.tools.convert_checkpoint unet \
        --src /path/to/lcm-ssd-1b/unet --out checkpoints/ssd-1b/unet --expect ssd-1b
    python -m fastedit_tpu_torch.tools.convert_checkpoint unet \
        --src .../sdxl-base/unet --lora .../lcm-lora-sdxl/pytorch_lora_weights.safetensors \
        --out checkpoints/sdxl/unet
    ... (controlnet | vae | text_encoder | text_encoder_2 | clip_vision |
         clip_text | dino | lpips | tokenizer)
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
from typing import Dict

import torch

from fastedit_tpu_torch.models import configs as C
from fastedit_tpu_torch.tools import hf_config, hf_mapping, lora
from fastedit_tpu_torch.utils import checkpoint as ckpt_io
from fastedit_tpu_torch.utils.logging import get_logger
from fastedit_tpu_torch.utils.safetensors_io import load_file

log = get_logger("convert")


def load_hf_state_dict(src_dir: str) -> Dict[str, torch.Tensor]:
    """Load every *.safetensors under src_dir into one flat dict."""
    files = sorted(glob.glob(os.path.join(src_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no .safetensors under {src_dir}")
    sd: Dict[str, torch.Tensor] = {}
    for f in files:
        sd.update(load_file(f))
    return sd


def load_hf_config(src_dir: str) -> dict:
    with open(os.path.join(src_dir, "config.json")) as f:
        return json.load(f)


DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32}


# Documented architecture defaults (models/configs.py) per --expect name.
# A converted checkpoint whose derived config drifts from these fails LOUDLY
# at conversion time instead of silently benching a wrong-depth architecture.
_EXPECTED_CONFIGS = {
    "ssd-1b": ("unet", lambda: C.SSD1B_UNET),
    "sdxl": ("unet", lambda: C.SDXL_UNET),
    "controlnet-small": ("controlnet", lambda: C.SDXL_CONTROLNET_SMALL),
    "controlnet-full": ("controlnet", lambda: C.SDXL_CONTROLNET_FULL),
    "vae": ("vae", lambda: C.SDXL_VAE),
}


def _assert_expected_config(expect: str, kind: str, derived) -> None:
    import dataclasses

    want_kind, want_fn = _EXPECTED_CONFIGS[expect]
    if kind != want_kind:
        raise SystemExit(
            f"--expect {expect} applies to kind '{want_kind}', got '{kind}'"
        )
    want = want_fn()
    if derived == want:
        log.info("derived config matches documented '%s' default", expect)
        return
    lines = [
        f"checkpoint config DRIFTS from the documented '{expect}' default "
        f"(models/configs.py). Field diff (derived vs documented):"
    ]

    def diff(obj_d, obj_w, prefix=""):
        for f in dataclasses.fields(obj_w):
            a, b = getattr(obj_d, f.name), getattr(obj_w, f.name)
            if dataclasses.is_dataclass(b):
                diff(a, b, prefix=f"{prefix}{f.name}.")
            elif a != b:
                lines.append(
                    f"  {prefix}{f.name}: derived={a!r} documented={b!r}"
                )

    diff(derived, want)
    lines.append(
        "Update models/configs.py (and tools/hf_vendored.py) to the real "
        "values, re-run tests, re-run bench — or drop --expect if converting "
        "a deliberately different architecture."
    )
    raise SystemExit("\n".join(lines))


def convert_component(kind: str, src: str, out: str, dtype: str = "bf16",
                      lora_path: str | None = None,
                      heads_src: str | None = None,
                      expect: str | None = None) -> None:
    torch_dtype = DTYPES[dtype]

    if kind == "tokenizer":
        os.makedirs(out, exist_ok=True)
        for name in ("vocab.json", "merges.txt"):
            shutil.copy(os.path.join(src, name), os.path.join(out, name))
        log.info("tokenizer files -> %s", out)
        return

    if expect is not None and expect not in _EXPECTED_CONFIGS:
        raise SystemExit(
            f"unknown --expect {expect!r}; choices: {sorted(_EXPECTED_CONFIGS)}"
        )

    sd = load_hf_state_dict(src)
    if kind == "unet":
        cfg_json = load_hf_config(src)
        cfg = hf_config.unet_config_from_hf(cfg_json)
        if expect is not None:
            _assert_expected_config(expect, kind, cfg)
        if lora_path:
            sd, n = lora.fuse_lora_into_state_dict(sd, load_file(lora_path))
            log.info("fused %d LoRA modules into the UNet", n)
        params = hf_mapping.convert_unet(sd, cfg, strict=True)
    elif kind == "controlnet":
        cfg_json = load_hf_config(src)
        cfg = hf_config.controlnet_config_from_hf(cfg_json)
        if expect is not None:
            _assert_expected_config(expect, kind, cfg)
        params = hf_mapping.convert_controlnet(sd, cfg, strict=True)
    elif kind == "vae":
        cfg_json = load_hf_config(src)
        cfg = hf_config.vae_config_from_hf(cfg_json)
        if expect is not None:
            _assert_expected_config(expect, kind, cfg)
        params = hf_mapping.convert_vae(sd, cfg, strict=True)
    elif kind in ("text_encoder", "text_encoder_2", "clip_text"):
        cfg_json = load_hf_config(src)
        if "text_config" in cfg_json:
            # combined CLIPModel repo (the CLIPScore backbone,
            # openai/clip-vit-base-patch16): the text tower's config is
            # nested and projection_dim lives at the top level — mirror the
            # clip_vision branch's unwrap (convert_clip_text already
            # tolerates the extra vision-tower keys in the state dict).
            cfg_json = dict(
                cfg_json["text_config"],
                projection_dim=cfg_json.get("projection_dim", 512),
            )
        with_proj = kind != "text_encoder" or "text_projection.weight" in sd
        cfg = hf_config.clip_text_config_from_hf(cfg_json, with_projection=with_proj)
        params = hf_mapping.convert_clip_text(sd, cfg, strict=True)
    elif kind == "clip_vision":
        cfg_json = load_hf_config(src)
        vcfg = cfg_json.get("vision_config", cfg_json)
        cfg = C.CLIPVisionConfig(
            image_size=vcfg.get("image_size", 224),
            patch_size=vcfg.get("patch_size", 16),
            hidden_size=vcfg.get("hidden_size", 768),
            num_layers=vcfg.get("num_hidden_layers", 12),
            num_heads=vcfg.get("num_attention_heads", 12),
            intermediate_size=vcfg.get("intermediate_size", 3072),
            projection_dim=cfg_json.get("projection_dim", 512),
        )
        params = hf_mapping.convert_clip_vision(sd, cfg, strict=True)
    elif kind == "dino":
        n_layers = sum(1 for k in sd if k.endswith(".attn.qkv.weight"))
        from fastedit_tpu_torch.metrics.dino import DINOConfig

        cfg = DINOConfig(num_layers=n_layers)
        params = hf_mapping.convert_dino_vit(sd, n_layers, strict=True)
    elif kind == "lpips":
        if heads_src is None:
            raise ValueError("lpips conversion needs --heads_src")
        heads = load_hf_state_dict(heads_src)
        cfg = None
        params = hf_mapping.convert_lpips_squeeze(sd, heads, strict=True)
    else:
        raise ValueError(f"unknown component kind: {kind}")

    ckpt_io.save_params(out, params, dtype=torch_dtype)
    if cfg is not None:
        ckpt_io.save_config(out, cfg)
    n_params = sum(x.numel() for x in ckpt_io.flatten(params).values())
    log.info("%s: %.1fM params -> %s (%s)", kind, n_params / 1e6, out, dtype)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument(
        "kind",
        choices=[
            "unet", "controlnet", "vae", "text_encoder", "text_encoder_2",
            "clip_text", "clip_vision", "dino", "lpips", "tokenizer",
        ],
    )
    p.add_argument("--src", required=True, help="HF snapshot component dir")
    p.add_argument("--out", required=True, help="output checkpoint dir")
    p.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    p.add_argument("--lora", default=None,
                   help="LoRA safetensors to fuse (unet only; LCM-LoRA path)")
    p.add_argument("--heads_src", default=None,
                   help="LPIPS linear-head weights dir (lpips only)")
    p.add_argument("--expect", default=None,
                   choices=sorted(_EXPECTED_CONFIGS),
                   help="fail loudly if the derived config drifts from the "
                        "documented models/configs.py default of this name")
    args = p.parse_args(argv)
    convert_component(
        args.kind, args.src, args.out, args.dtype, args.lora, args.heads_src,
        expect=args.expect,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
