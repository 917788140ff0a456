"""FastEditor — the one-call image editing facade, on one NVIDIA card.

The same constructor knobs, ``MODEL_CONFIGS`` keys and methods as the JAX
package's ``FastEditor``: ``preprocess_image``, ``edit`` (with
``strength``), ``edit_batch``, ``warmup``, ``clear_memory`` and
``get_memory_usage``.  It runs on the card unless the caller asks for
``device="cpu"``.  ``random_weights=True`` builds the full architecture
with zero weights (edit latency does not depend on the weights), and
``"tiny"`` is a seeded random-weight smoke model with the real topology.

Not in this slice (see ROADMAP.md): loading converted checkpoints (P12),
the fp32 quality mode on the card (P17), ``edit_batch_async`` /
``stage_inputs`` and data parallelism (P10/P15).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
from PIL import Image

from fastedit_tpu_torch.models import configs as C
from fastedit_tpu_torch.models.clip import CLIPTextModel
from fastedit_tpu_torch.models.controlnet import ControlNetModel
from fastedit_tpu_torch.models.layers import GroupNorm, LayerNorm, cast_model
from fastedit_tpu_torch.models.unet import UNet2DConditionModel
from fastedit_tpu_torch.models.vae import AutoencoderKL
from fastedit_tpu_torch.ops.canny import canny
from fastedit_tpu_torch.pipeline import stages
from fastedit_tpu_torch.sched.lcm import LCMSchedulerConfig, make_schedule
from fastedit_tpu_torch.text.tokenizer import CLIPTokenizer
from fastedit_tpu_torch.utils.image import resize


def _normalize_dtype(dtype) -> torch.dtype:
    """Accept torch/numpy dtypes and strings; float16 maps to bf16."""
    name = str(dtype).replace("torch.", "")
    mapping = {
        "float16": torch.bfloat16,
        "half": torch.bfloat16,
        "bfloat16": torch.bfloat16,
        "float32": torch.float32,
        "float": torch.float32,
        "float64": torch.float32,
    }
    if name not in mapping:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return mapping[name]


def _resolve_device(device: Optional[str]) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' to run the plain versions on the CPU"
        )
    return dev


@torch.no_grad()
def _seeded_init_(model: nn.Module, generator: torch.Generator) -> None:
    """Fan-in-scaled normal weights, zero biases, identity norms."""
    for m in model.modules():
        if isinstance(m, (GroupNorm, LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, fan_in**-0.5, generator=generator)
            if m.bias is not None:
                m.bias.zero_()


def _build(cls, cfg, device, dtype, generator: Optional[torch.Generator]):
    """Construct without initialising (meta), allocate on ``device`` and
    fill: seeded random weights with a generator, zeros without."""
    with torch.device("meta"):
        model = cls(cfg)
    cast_model(model, None, dtype)
    model.to_empty(device=device)
    with torch.no_grad():
        if generator is None:
            for p in model.parameters():
                p.zero_()
        else:
            _seeded_init_(model, generator)
    return model.eval().requires_grad_(False)


class FastEditor:
    """Fast image editor: SDXL/SSD-1B + LCM + ControlNet-Canny on one card."""

    MODEL_CONFIGS = {
        "sdxl": {
            "base_model": "stabilityai/stable-diffusion-xl-base-1.0",
            "lcm_lora": "latent-consistency/lcm-lora-sdxl",
            "use_full_lcm": False,
            "unet_config": C.SDXL_UNET,
            "resolution": 1024,
            "description": "Full SDXL + fused LCM-LoRA",
        },
        "ssd-1b": {
            "base_model": "segmind/SSD-1B",
            "lcm_model": "latent-consistency/lcm-ssd-1b",
            "use_full_lcm": True,
            "unet_config": C.SSD1B_UNET,
            "resolution": 1024,
            "description": "SSD-1B distilled (50% smaller, faster)",
        },
        "tiny": {
            "use_full_lcm": True,
            "unet_config": C.TINY_UNET,
            "resolution": 64,
            "description": "Random-weight smoke model (tests/demo, real topology)",
        },
    }

    def __init__(
        self,
        model_name: str = "sdxl",
        device: Optional[str] = None,
        dtype=torch.bfloat16,
        enable_cpu_offload: bool = False,
        use_full_precision: bool = False,
        use_full_controlnet: bool = False,
        checkpoint_dir: Optional[str] = None,
        init_seed: int = 0,
        random_weights: bool = False,
    ):
        if model_name not in self.MODEL_CONFIGS:
            raise ValueError(
                f"Unknown model: {model_name}. Choose from {list(self.MODEL_CONFIGS)}"
            )
        self.model_name = model_name
        self.config = self.MODEL_CONFIGS[model_name]
        self.device = _resolve_device(device)
        self.dtype = torch.float32 if use_full_precision else _normalize_dtype(dtype)
        if self.device.type == "cuda" and self.dtype != torch.bfloat16:
            raise NotImplementedError(
                "fp32 on the card (use_full_precision / dtype=float32) is a later "
                "slice (ROADMAP P17): this slice's CUDA kernels take bf16"
            )
        self.use_full_controlnet = use_full_controlnet
        self.enable_cpu_offload = enable_cpu_offload  # accepted, not needed
        self.resolution = self.config["resolution"]

        if model_name == "tiny":
            self._init_models(
                C.TINY_UNET, C.TINY_CONTROLNET, C.TINY_VAE, C.TINY_TEXT_ENCODER,
                C.TINY_TEXT_ENCODER_2,
                torch.Generator(device=self.device).manual_seed(init_seed),
            )
            cn_ds = 2 ** (len(C.TINY_CONTROLNET.conditioning_embedding_channels) - 1)
            self._control_res = self.resolution // C.TINY_VAE.downscale_factor * cn_ds
        elif random_weights:
            cn_cfg = C.SDXL_CONTROLNET_FULL if use_full_controlnet else C.SDXL_CONTROLNET_SMALL
            self._init_models(
                self.config["unet_config"], cn_cfg, C.SDXL_VAE, C.SDXL_TEXT_ENCODER,
                C.SDXL_TEXT_ENCODER_2, None,
            )
            self._control_res = self.resolution
        else:
            raise NotImplementedError(
                "loading converted checkpoints is a later slice (ROADMAP P12); "
                "use random_weights=True or the 'tiny' model"
                + (f" (checkpoint_dir={checkpoint_dir!r})" if checkpoint_dir else "")
            )
        self.scheduler_config = LCMSchedulerConfig()
        self._prompt_cache: dict = {}
        self._schedule_cache: dict = {}

    def _init_models(self, unet_cfg, cn_cfg, vae_cfg, te1_cfg, te2_cfg, generator):
        dev, dt = self.device, self.dtype
        self.modules = stages.PipelineModules(
            unet=_build(UNet2DConditionModel, unet_cfg, dev, dt, generator),
            controlnet=_build(ControlNetModel, cn_cfg, dev, dt, generator),
            vae=_build(AutoencoderKL, vae_cfg, dev, dt, generator),
            text_encoder=_build(CLIPTextModel, te1_cfg, dev, dt, generator),
            text_encoder_2=_build(CLIPTextModel, te2_cfg, dev, dt, generator),
            vae_scaling_factor=vae_cfg.scaling_factor,
        )
        self.tokenizer = CLIPTokenizer.synthetic(vocab_size=te1_cfg.vocab_size)
        self.tokenizer_2 = CLIPTokenizer.synthetic(
            vocab_size=te2_cfg.vocab_size, pad_token_id=0
        )

    # ------------------------------------------------------------ preprocess

    def preprocess_image(
        self, image: Image.Image, low_threshold: int = 100, high_threshold: int = 200
    ) -> Image.Image:
        """PIL RGB -> Canny edge map as 3-channel RGB PIL (ControlNet input)."""
        arr = torch.from_numpy(np.asarray(image.convert("RGB"), dtype=np.uint8).copy())
        edges = canny(arr.to(self.device), low_threshold, high_threshold).cpu().numpy()
        return Image.fromarray(np.stack([edges] * 3, axis=2))

    # ------------------------------------------------------------------ edit

    def _encode_prompts(self, prompts) -> None:
        """Encode every novel prompt in one text-encoder call and cache it."""
        novel = list(dict.fromkeys(p for p in prompts if p not in self._prompt_cache))
        if not novel:
            return
        ids1 = torch.from_numpy(np.stack([self.tokenizer.encode(p) for p in novel]))
        ids2 = torch.from_numpy(np.stack([self.tokenizer_2.encode(p) for p in novel]))
        ctx, pooled = stages.encode_prompt(
            self.modules, ids1.long().to(self.device), ids2.long().to(self.device)
        )
        for i, p in enumerate(novel):
            self._prompt_cache[p] = (ctx[i : i + 1], pooled[i : i + 1])
        while len(self._prompt_cache) > 4096:
            self._prompt_cache.pop(next(iter(self._prompt_cache)))

    def _schedule(self, num_inference_steps: int, strength: float):
        key = (num_inference_steps, float(strength))
        if key not in self._schedule_cache:
            self._schedule_cache[key] = make_schedule(
                self.scheduler_config, num_inference_steps, strength=strength
            )
        return self._schedule_cache[key]

    def _noise(self, seed: int, shape, num_steps: int):
        """(posterior eps, initial noise, one noise per step), fp32 standard
        normals of ``shape`` from one seeded generator on the device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        draws = [
            torch.randn(shape, generator=gen, device=self.device)
            for _ in range(num_steps + 2)
        ]
        return draws[0], draws[1], draws[2:]

    def _run_edit(
        self, images, prompts, negative_prompt, strength, num_inference_steps,
        guidance_scale, controlnet_conditioning_scale, canny_low_threshold,
        canny_high_threshold, seed, tile_noise: bool,
    ) -> np.ndarray:
        """Shared single/batch path; returns uint8 [B, r, r, 3] on the host."""
        b = len(images)
        r = self.resolution
        img_u8 = np.stack(
            [np.asarray(resize(im.convert("RGB"), r), dtype=np.uint8) for im in images]
        )
        inputs = torch.from_numpy(img_u8).to(self.device)

        do_cfg = guidance_scale > 1.0
        self._encode_prompts(list(prompts) + ([negative_prompt] if do_cfg else []))
        enc = [self._prompt_cache[p] for p in prompts]
        ctx_c = torch.cat([e[0] for e in enc])
        pooled_c = torch.cat([e[1] for e in enc])
        if do_cfg:  # pair-interleaved (u_i, c_i)
            ctx_u, pooled_u = self._prompt_cache[negative_prompt]
            context = torch.stack([ctx_u.expand_as(ctx_c), ctx_c], dim=1).reshape(
                2 * b, *ctx_c.shape[1:]
            )
            pooled = torch.stack([pooled_u.expand_as(pooled_c), pooled_c], dim=1).reshape(
                2 * b, *pooled_c.shape[1:]
            )
        else:
            context, pooled = ctx_c, pooled_c
        time_ids = stages.make_sdxl_time_ids(context.shape[0], r, self.device)
        schedule = self._schedule(num_inference_steps, strength)

        if seed is None:
            seed = int.from_bytes(os.urandom(4), "little")
        lat_shape = (1 if tile_noise else b, r // 8, r // 8, 4)
        eps_enc, noise_init, step_noise = self._noise(seed, lat_shape, schedule.num_steps)

        mod = self.modules
        control, vae_in = stages.prepare(
            mod, inputs, canny_low_threshold, canny_high_threshold, self._control_res
        )
        latents = stages.vae_sample(mod, vae_in, eps_enc)
        latents = stages.denoise(
            mod, latents, context, pooled, time_ids, control, schedule,
            guidance_scale, controlnet_conditioning_scale, noise_init, step_noise, do_cfg,
        )
        return stages.vae_decode(mod, latents).cpu().numpy()

    def edit(
        self,
        image: Image.Image,
        prompt: str,
        negative_prompt: str = "",
        strength: float = 0.80,
        num_inference_steps: int = 4,
        guidance_scale: float = 1.5,
        controlnet_conditioning_scale: float = 0.5,
        canny_low_threshold: int = 100,
        canny_high_threshold: int = 200,
        seed: Optional[int] = None,
    ) -> Image.Image:
        """Edit ``image`` per ``prompt``; returns the edited PIL image."""
        out = self._run_edit(
            [image], [prompt], negative_prompt, strength, num_inference_steps,
            guidance_scale, controlnet_conditioning_scale, canny_low_threshold,
            canny_high_threshold, seed, tile_noise=False,
        )
        return Image.fromarray(out[0])

    def edit_batch(
        self,
        images: list,
        prompts: list,
        negative_prompt: str = "",
        strength: float = 0.80,
        num_inference_steps: int = 4,
        guidance_scale: float = 1.5,
        controlnet_conditioning_scale: float = 0.5,
        canny_low_threshold: int = 100,
        canny_high_threshold: int = 200,
        seed: Optional[int] = None,
    ) -> list:
        """Edit a batch in one pass.  With a fixed ``seed`` every image gets
        the same noise stream, as with same-seeded per-image generators."""
        if len(images) != len(prompts) or not images:
            raise ValueError("edit_batch needs as many prompts as images (>= 1)")
        out = self._run_edit(
            images, prompts, negative_prompt, strength, num_inference_steps,
            guidance_scale, controlnet_conditioning_scale, canny_low_threshold,
            canny_high_threshold, seed, tile_noise=seed is not None and len(images) > 1,
        )
        return [Image.fromarray(o) for o in out]

    # ----------------------------------------------------------------- misc

    def clear_memory(self):
        """Drop cached prompt embeddings and schedules (weights stay)."""
        self._prompt_cache.clear()
        self._schedule_cache.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def get_memory_usage(self):
        """Device memory in GiB: allocated, reserved and peak allocated."""
        if self.device.type != "cuda":
            return {"allocated_gb": 0.0, "reserved_gb": 0.0, "peak_gb": 0.0}
        gib = 1024**3
        return {
            "allocated_gb": torch.cuda.memory_allocated(self.device) / gib,
            "reserved_gb": torch.cuda.memory_reserved(self.device) / gib,
            "peak_gb": torch.cuda.max_memory_allocated(self.device) / gib,
        }

    def warmup(self, **edit_kwargs):
        """One dummy edit (builds the kernels on first use); returns seconds."""
        dummy = Image.new("RGB", (self.resolution, self.resolution), (128, 128, 128))
        t0 = time.time()
        edit_kwargs.setdefault("seed", 0)
        self.edit(dummy, "warmup", **edit_kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.time() - t0
