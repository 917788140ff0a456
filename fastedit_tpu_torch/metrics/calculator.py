"""MetricsCalculator — the six-metric evaluation facade (a port of the JAX
package's ``metrics/calculator.py``).

The reference's method names and conventions (src/metrics.py:150-387):
pairwise metrics at 512x512 LANCZOS; the CLIP score on the edited image as
given (uint8, resized to the tower's 224 bicubic); DINO at 224 with ImageNet
normalisation, layer-11 key self-similarity MSE.

The learned backbones (LPIPS-SqueezeNet, CLIP ViT-B/16, DINO ViT-B/8) load
from ``<weights_dir>/{lpips,clip_vision,clip_text,dino}``, converted by
``tools/convert_checkpoint.py`` (the layout both packages read).  Without
them the learned metrics fail closed (NaN) unless ``allow_random=True`` or
``tiny=True``, which build seeded random backbones on first use.  SSIM, PSNR
and MSE are exact either way.  Every metric runs in true fp32
(``utils/precision.true_fp32``), on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
from PIL import Image

from fastedit_tpu_torch.metrics import functional as F
from fastedit_tpu_torch.metrics.dino import (
    DINO_VITB8,
    IMAGENET_MEAN,
    IMAGENET_STD,
    TINY_DINO,
    DINOConfig,
    DINOViT,
    dino_distance,
)
from fastedit_tpu_torch.metrics.lpips import LPIPS
from fastedit_tpu_torch.models import configs as C
from fastedit_tpu_torch.models.clip import CLIPTextModel, CLIPVisionModel
from fastedit_tpu_torch.pipeline.editor import _resolve_device, _seeded_init_
from fastedit_tpu_torch.text.tokenizer import CLIPTokenizer
from fastedit_tpu_torch.tools import from_jax
from fastedit_tpu_torch.utils import checkpoint as ckpt_io
from fastedit_tpu_torch.utils.precision import true_fp32  # noqa: F401 (re-exported)

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)
BACKBONES = ("lpips", "clip_vision", "clip_text", "dino")


@torch.no_grad()
def _random_init_(model: nn.Module, generator: torch.Generator) -> None:
    """The editor's seeded init, and N(0, 0.02) for the parameters that
    belong to no layer (the class embedding, the CLS token and the DINO
    position embedding)."""
    _seeded_init_(model, generator)
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] in ("class_embedding", "cls_token", "pos_embed"):
            p.normal_(0.0, 0.02, generator=generator)


def _rgb(img: Image.Image) -> np.ndarray:
    return np.asarray(img.convert("RGB"), dtype=np.float32)


class MetricsCalculator:
    """Six-metric calculator (SSIM, LPIPS, CLIP score, PSNR, MSE, DINO)."""

    def __init__(
        self,
        device: Optional[str] = None,
        weights_dir: Optional[str] = None,
        tiny: bool = False,
        init_seed: int = 0,
        allow_random: bool = False,
    ):
        self.device = _resolve_device(device)
        self.metric_size = (512, 512)
        self.init_seed = init_seed
        weights_dir = weights_dir or os.path.join("checkpoints", "metrics")
        backend = (f"cuda ({torch.cuda.get_device_name(self.device)})"
                   if self.device.type == "cuda" else self.device.type)
        print(f"[MetricsCalculator] Initializing on {backend} (requested: {device})...")

        if tiny:
            self.clip_vision_cfg, clip_text_cfg = C.TINY_CLIP_VISION, C.TINY_CLIP_TEXT
            self.dino_cfg: DINOConfig = TINY_DINO
        else:
            self.clip_vision_cfg, clip_text_cfg = C.CLIP_B16_VISION, C.CLIP_B16_TEXT
            self.dino_cfg = DINO_VITB8
        with torch.device("meta"):
            self._models = {
                "lpips": LPIPS(), "clip_vision": CLIPVisionModel(self.clip_vision_cfg),
                "clip_text": CLIPTextModel(clip_text_cfg), "dino": DINOViT(self.dino_cfg),
            }
        state_dicts = {
            "lpips": from_jax.lpips_state_dict,
            "clip_vision": lambda p: from_jax.clip_vision_state_dict(p, self.clip_vision_cfg),
            "clip_text": lambda p: from_jax.clip_text_state_dict(p, clip_text_cfg),
            "dino": lambda p: from_jax.dino_state_dict(p, self.dino_cfg.num_layers),
        }
        self._ready: set = set()
        missing = []
        for name in BACKBONES:
            path = os.path.join(weights_dir, name)
            if os.path.isdir(path):
                params = ckpt_io.load_params(path, torch.float32)
                self._materialize(name).load_state_dict(state_dicts[name](params))
            else:
                missing.append(name)  # random weights made on first use, if allowed
        # Fail closed: learned metrics never silently report random-weight
        # numbers.  Tiny mode is a smoke configuration and exempt;
        # ``allow_random`` is the explicit opt-in.
        self.random_backbones = tuple(missing) if not tiny else ()
        self.learned_enabled = not self.random_backbones or allow_random
        if missing and not tiny:
            warnings.warn(
                f"[MetricsCalculator] no converted weights for {missing} under "
                f"{weights_dir}; LPIPS/CLIP/DINO "
                + ("will use RANDOM weights (allow_random=True) — values are not "
                   "meaningful." if allow_random else
                   "are DISABLED and will report NaN (pass allow_random=True to "
                   "override).")
                + " SSIM/PSNR/MSE are unaffected. Run tools/convert_checkpoint.py "
                "to enable learned metrics."
            )
        tok_dir = os.path.join(weights_dir, "clip_tokenizer")
        if os.path.isdir(tok_dir):
            self.clip_tokenizer = CLIPTokenizer.from_dir(tok_dir)
        else:
            if not tiny and not allow_random and "clip_text" not in self.random_backbones:
                # Real CLIP weights but no real vocab: synthetic ids bear no
                # relation to the trained embedding table, so fail closed too.
                self.random_backbones = self.random_backbones + ("clip_tokenizer",)
                self.learned_enabled = False
                warnings.warn(
                    f"[MetricsCalculator] converted CLIP weights found but no "
                    f"tokenizer under {tok_dir}; learned metrics are DISABLED (NaN) "
                    f"— convert the tokenizer files (vocab.json/merges.txt) alongside "
                    f"the weights."
                )
            self.clip_tokenizer = CLIPTokenizer.synthetic(vocab_size=clip_text_cfg.vocab_size)
        print("[MetricsCalculator] Initialization complete!")

    # ------------------------------------------------------------ backbones

    def _materialize(self, name: str) -> nn.Module:
        model = self._models[name].to_empty(device=self.device).eval().requires_grad_(False)
        self._models[name] = model
        self._ready.add(name)
        return model

    def _backbone(self, name: str) -> nn.Module:
        """A backbone, made with seeded random weights on its first use if
        none were loaded."""
        if name not in self._ready:
            gen = torch.Generator(device=self.device).manual_seed(
                self.init_seed + BACKBONES.index(name))
            _random_init_(self._materialize(name), gen)
        return self._models[name]

    # ----------------------------------------------------------- conversion

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32)).to(self.device)

    def _stack_512(self, images) -> torch.Tensor:
        """Images resized to 512x512 LANCZOS, [B, 512, 512, 3] in [0, 1]."""
        return self._tensor(np.stack([
            _rgb(img if img.size == self.metric_size
                 else img.resize(self.metric_size, Image.LANCZOS)) for img in images]) / 255.0)

    def _clip_pixels(self, images) -> torch.Tensor:
        size = self.clip_vision_cfg.image_size
        return self._tensor(np.stack([
            (_rgb(img.convert("RGB").resize((size, size), Image.BICUBIC)) / 255.0
             - np.asarray(CLIP_IMAGE_MEAN)) / np.asarray(CLIP_IMAGE_STD) for img in images]))

    def _dino_pixels(self, images) -> torch.Tensor:
        size = self.dino_cfg.image_size
        arr = np.stack([_rgb(img.convert("RGB").resize((size, size), Image.BILINEAR)) / 255.0
                        for img in images])
        return self._tensor((arr - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD))

    # ------------------------------------------------------------- metrics

    @torch.no_grad()
    def _pair_metric(self, fn, img1, img2) -> float:
        with true_fp32():
            return float(fn(*(self._stack_512([im]) for im in (img1, img2))))

    def calculate_ssim(self, img1: Image.Image, img2: Image.Image) -> float:
        return self._pair_metric(F.ssim, img1, img2)

    def calculate_psnr(self, img1: Image.Image, img2: Image.Image) -> float:
        return self._pair_metric(F.psnr, img1, img2)

    def calculate_mse(self, img1: Image.Image, img2: Image.Image) -> float:
        return self._pair_metric(F.mse, img1, img2)

    def _lpips(self, src, edt) -> torch.Tensor:
        return self._backbone("lpips")(src * 2 - 1, edt * 2 - 1)

    def calculate_lpips(self, img1: Image.Image, img2: Image.Image) -> float:
        if not self.learned_enabled:
            return float("nan")
        return self._pair_metric(lambda a, b: self._lpips(a, b)[0], img1, img2)

    def _clip_score(self, pixels, ids) -> torch.Tensor:
        img = self._backbone("clip_vision")(pixels)
        txt = self._backbone("clip_text")(ids).pooled_output
        img = img / img.norm(dim=-1, keepdim=True)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        return (100.0 * (img * txt).sum(dim=-1)).clamp(min=0.0)  # [B]

    def _ids(self, texts) -> torch.Tensor:
        return torch.from_numpy(self.clip_tokenizer.batch_encode(list(texts))).long().to(
            self.device)

    @torch.no_grad()
    def calculate_clip_score(self, img: Image.Image, text: str) -> float:
        if not self.learned_enabled:
            return float("nan")
        with true_fp32():
            return float(self._clip_score(self._clip_pixels([img]), self._ids([text]))[0])

    def _dino(self, src, edt) -> torch.Tensor:
        dino, layer = self._backbone("dino"), self.dino_cfg.num_layers - 1
        return dino_distance(dino(src, layer), dino(edt, layer))

    @torch.no_grad()
    def calculate_dino_distance(self, source_img: Image.Image,
                                edited_img: Image.Image) -> float:
        if not self.learned_enabled:
            return float("nan")
        with true_fp32():
            return float(self._dino(self._dino_pixels([source_img]),
                                    self._dino_pixels([edited_img]))[0])

    def calculate_all_metrics(self, source_img: Image.Image, edited_img: Image.Image,
                              prompt: str) -> dict:
        """All six metrics (reference src/metrics.py:349-381 conventions): the
        values of the six ``calculate_*`` calls, from one resize of the
        pair (the host's resizes are most of a pair's time)."""
        return self.calculate_all_metrics_batch([source_img], [edited_img], [prompt])[0]

    @torch.no_grad()
    def calculate_all_metrics_batch(self, source_imgs, edited_imgs, prompts) -> list:
        """The six metrics of every pair, as ``calculate_all_metrics`` gives
        them, one batched call per metric."""
        n = len(source_imgs)
        if len(edited_imgs) != n or len(prompts) != n:
            raise ValueError("calculate_all_metrics_batch needs as many edited images and "
                             "prompts as source images")
        with true_fp32():
            src, edt = self._stack_512(source_imgs), self._stack_512(edited_imgs)
            out = {"ssim": F.ssim(src, edt, per_image=True),
                   "psnr": F.psnr(src, edt, per_image=True),
                   "mse": F.mse(src, edt, per_image=True)}
            if self.learned_enabled:
                out["lpips"] = self._lpips(src, edt)
                out["clip_score"] = self._clip_score(self._clip_pixels(edited_imgs),
                                                     self._ids(prompts))
                out["dino_distance"] = self._dino(self._dino_pixels(source_imgs),
                                                  self._dino_pixels(edited_imgs))
            host = {k: v.cpu().tolist() for k, v in out.items()}
        nan = [float("nan")] * n
        keys = ("ssim", "lpips", "clip_score", "psnr", "mse", "dino_distance")
        return [{k: float(host.get(k, nan)[i]) for k in keys} for i in range(n)]

    def clear_memory(self):
        """Drop the card's cached allocations (the backbones stay)."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
