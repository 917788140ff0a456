"""Pipeline stages: prompt encode / prepare / VAE sample / denoise / decode.

The edit path is Canny prepare -> VAE encode -> LCM denoise loop
(ControlNet + UNet on a pair-interleaved CFG batch) -> VAE decode to
uint8, as in the JAX package's ``pipeline/stages.py``.  Each stage is a
plain function of its modules and tensors, with no host synchronisation in
prepare (the Canny kernel of ``ops/canny.py``), VAE encode, denoise and VAE
decode, so ``pipeline/graphs.py`` can capture each of them as a CUDA graph.
The Canny thresholds, the schedule and both scales are device tensors
(``canny.threshold_tensors``, :func:`edit_scalars`), so one graph serves
every threshold, strength and scale.  Every stage that needs random numbers takes them as explicit
tensors: the editor draws them from a ``torch.Generator``, and the parity
tests pass the JAX package's own ``jax.random`` draws.

Semantics mirrored from the JAX package:
  * context = concat(penultimate states of both towers), pooled = tower 2's
    projected pooled embedding;
  * CFG batch pair-interleaved (u0, c0, u1, c1, ...); CFG skipped when
    guidance <= 1;
  * the ControlNet conditioning tower runs once per edit at batch B;
  * initial noise added in fp32; LCM step in fp32;
  * decode ``(clip(x/2 + 0.5) * 255 + 0.5)`` to uint8, one image at a time;
  * each of VAE encode, denoise (the conditioning tower included) and VAE
    decode runs in its own kernel context (``flags.stage``): by default the
    conv kernels with up2 and down2 in the loop, the conv kernels with
    whole-resnet fusion and up2 in the decoder, PyTorch's convs in the
    encoder;
  * with ``utils/profiling.enable_nan_checks`` on (the editor then runs
    eagerly), each stage's output is checked for NaN and infinity
    (``check_finite``: off, a Python test and no device work).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from fastedit_tpu_torch.models.clip import CLIPTextModel
from fastedit_tpu_torch.models.controlnet import ControlNetModel
from fastedit_tpu_torch.models.unet import UNet2DConditionModel
from fastedit_tpu_torch.models.vae import AutoencoderKL
from fastedit_tpu_torch.ops import flags
from fastedit_tpu_torch.ops import canny
from fastedit_tpu_torch.sched.lcm import LCMSchedule, add_noise, lcm_step
from fastedit_tpu_torch.utils.profiling import check_finite


@dataclasses.dataclass
class PipelineModules:
    """The models of one editor instance (weights live in the modules)."""

    unet: UNet2DConditionModel
    controlnet: ControlNetModel
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    text_encoder_2: CLIPTextModel
    vae_scaling_factor: float

    @property
    def dtype(self) -> torch.dtype:
        return self.unet.conv_in.weight.dtype


@torch.no_grad()
def encode_prompt(mod: PipelineModules, ids_1: torch.Tensor, ids_2: torch.Tensor):
    """[B, 77] token ids x2 -> (context [B, 77, D1+D2], pooled [B, P])."""
    out1 = mod.text_encoder(ids_1)
    out2 = mod.text_encoder_2(ids_2)
    context = torch.cat(
        [out1.penultimate_hidden_state, out2.penultimate_hidden_state], dim=-1
    )
    check_finite("encode_prompt", context, out2.pooled_output)
    return context, out2.pooled_output


@torch.no_grad()
def prepare(mod: PipelineModules, img_u8: torch.Tensor, low, high, control_res: int):
    """uint8 [B, H, W, 3] -> (canny control [B, r, r, 3] in {0, 1}, VAE input
    [B, H, W, 3] in [-1, 1]), both in the model dtype.  On the card the
    Canny kernel (``ops/canny.prepare``, one launch), with the thresholds as int32
    device tensors (``canny.threshold_tensors``): no host sync, so the
    editor captures prepare as the first graph of its chain; on the CPU, or
    with ``plain_versions``, the plain version."""
    fn = flags.kernel_or_plain(canny.prepare, canny.prepare_plain)
    control, vae_in = fn(img_u8, low, high, mod.dtype)
    if control_res != control.shape[1]:
        control = F.interpolate(
            control.float().permute(0, 3, 1, 2), size=(control_res, control_res),
            mode="nearest-exact",
        ).permute(0, 2, 3, 1).to(mod.dtype).contiguous()
    check_finite("prepare", control, vae_in)
    return control, vae_in


@torch.no_grad()
def vae_sample(mod: PipelineModules, image: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """[-1, 1] image -> scaled posterior-sampled latents.  ``eps`` is a
    standard normal draw of the latent shape, or of batch 1 to give every
    image the same noise."""
    with flags.stage("encode"):
        mean, logvar = mod.vae.encode_moments(image)
    latents = AutoencoderKL.sample(mean, logvar, eps) * mod.vae_scaling_factor
    check_finite("vae_encode", latents)
    return latents


@torch.no_grad()
def vae_decode(mod: PipelineModules, latents: torch.Tensor) -> torch.Tensor:
    """Scaled latents [B, h, w, 4] -> uint8 images [B, H, W, 3], decoding
    one image at a time (peak memory stays that of one image)."""
    out = []
    with flags.stage("decode"):
        for i in range(latents.shape[0]):
            img = mod.vae.decode(latents[i : i + 1] / mod.vae_scaling_factor)
            check_finite("vae_decode", img)
            img01 = (img.float() / 2 + 0.5).clamp(0.0, 1.0)
            out.append((img01 * 255.0 + 0.5).to(torch.uint8))
    return torch.cat(out)


def edit_scalars(mod: PipelineModules, guidance_scale: float, controlnet_scale: float,
                 device) -> tuple[torch.Tensor, torch.Tensor]:
    """(guidance, ControlNet scale) as 0-dim tensors on ``device``: the
    guidance rounded to the model dtype (the dtype of eps), as the JAX
    package rounds it, the ControlNet scale in fp32."""
    gs = torch.tensor(guidance_scale, dtype=torch.float32).to(mod.dtype)
    return gs.to(device), torch.tensor(controlnet_scale, dtype=torch.float32).to(device)


@torch.no_grad()
def denoise(
    mod: PipelineModules,
    latents: torch.Tensor,  # [B, h, w, 4] clean scaled latents
    context: torch.Tensor,  # [B, 77, D]; CFG: [2B] pair-interleaved
    pooled: torch.Tensor,  # [B or 2B, P]
    time_ids: torch.Tensor,  # [B or 2B, 6]
    control_image: torch.Tensor,  # [B, H, W, 3] in [0, 1]
    schedule: LCMSchedule,  # its table on the latents' device
    guidance_scale: torch.Tensor,  # 0-dim, model dtype (edit_scalars)
    controlnet_scale: torch.Tensor,  # 0-dim fp32
    noise_init: torch.Tensor,  # fp32, latents' shape (or batch 1)
    step_noise: Sequence[torch.Tensor],  # one fp32 draw per step
    do_cfg: bool,
) -> torch.Tensor:
    """The LCM loop: ControlNet + UNet under CFG, one LCM step per
    timestep.  Returns the final latents."""
    b = latents.shape[0]
    if do_cfg and context.shape[0] != 2 * b:
        raise ValueError("CFG expects a pair-interleaved [2B] context")
    if len(step_noise) != schedule.num_steps:
        raise ValueError(f"need {schedule.num_steps} step noises, got {len(step_noise)}")
    with flags.stage("denoise"):
        return _denoise_body(
            mod, latents, context, pooled, time_ids, control_image, schedule,
            guidance_scale, controlnet_scale, noise_init, step_noise, do_cfg, b,
        )


def _denoise_body(mod, latents, context, pooled, time_ids, control_image, schedule,
                  guidance_scale, controlnet_scale, noise_init, step_noise, do_cfg, b):
    cn = mod.controlnet
    cond_feat = cn.controlnet_cond_embedding(control_image.to(mod.dtype))
    cond_in = cond_feat.repeat_interleave(2, dim=0) if do_cfg else cond_feat
    lat = add_noise(schedule, latents.float(), noise_init).to(latents.dtype)
    for i in range(schedule.num_steps):
        lat_in = lat.repeat_interleave(2, dim=0) if do_cfg else lat
        t_in = schedule.value("timesteps", i).expand(lat_in.shape[0])
        down_res, mid_res = cn(
            lat_in, t_in, context, pooled, time_ids, cond_in, controlnet_scale,
            cond_pre_embedded=True,
        )
        eps = mod.unet(
            lat_in, t_in, context, pooled, time_ids,
            down_block_additional_residuals=down_res,
            mid_block_additional_residual=mid_res,
        )
        if do_cfg:
            e = eps.reshape(b, 2, *eps.shape[1:])
            eps_u, eps_c = e[:, 0], e[:, 1]
            eps = eps_u + guidance_scale * (eps_c - eps_u)
        lat = lcm_step(schedule, i, lat, eps, step_noise[i].expand_as(lat))
        check_finite("denoise", lat, step=i)
    return lat


def make_sdxl_time_ids(batch: int, size: int, device=None) -> torch.Tensor:
    """SDXL micro-conditioning ids (orig_h, orig_w, crop_t, crop_l, tgt_h,
    tgt_w): the img2img pipeline passes the model resolution for both."""
    ids = torch.tensor([[size, size, 0, 0, size, size]], dtype=torch.float32)
    return ids.repeat(batch, 1).to(device)
