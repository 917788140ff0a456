"""The edit, in plain PyTorch: ControlNet-Canny img2img under an LCM sampler.

From the uint8 scenes, the prompts and the seed that the benchmark handed to
the program, the reference works out everything again: the token ids, both
CLIP towers' prompt embeddings (the penultimate states side by side, tower
2's projected pooled output), the Canny map, the VAE posterior sample, the
sampler's tables, the noise, the denoise loop (the ControlNet's residuals
into the UNet, classifier-free guidance over (negative, prompt) pairs) and
the decoded image.  The noise comes from one ``torch.Generator`` seeded with
the edit's seed on the device the edit ran on, drawn as latents
[Bn, h, w, 4] in the order (posterior sample, initial noise, one per run
step); ``Bn`` is 1 where a seeded batch shares one draw.

Nothing here imports the program: the models are ``models.py``, the weights
are the benchmark's own seeded draw (``benchmark/weights.py``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from benchmark.reference import canny, models, schedule, text
from benchmark.reference.numerics import Numerics


@contextlib.contextmanager
def true_fp32():
    """TF32 off for PyTorch's own matmuls and convolutions."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


class Reference:
    """The five models of a configuration on ``device``, in fp32, with the
    weights ``weights`` gives (``{"unet.conv_in.weight": tensor, ...}``)."""

    def __init__(self, cfg: dict, weights, device, mode: str = "fp32"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.models = models.build(cfg)
        for m in self.models.values():
            m.to_empty(device=self.device)
        params = {f"{k}.{n}": p for k, m in self.models.items()
                  for n, p in m.named_parameters()}
        with torch.no_grad():
            for name, value in weights:
                params.pop(name).copy_(value.float())
        if params:
            raise ValueError(f"no weights for {sorted(params)[:5]} ...")
        for m in self.models.values():
            m.eval().requires_grad_(False)
        self.set_mode(mode)

    def set_mode(self, mode: str) -> None:
        num = Numerics(mode)
        for m in self.models.values():
            models.set_numerics(m, num)

    def _encode(self, prompts: list):
        te1, te2 = self.cfg["text_encoder"], self.cfg["text_encoder_2"]
        ids1 = text.token_ids(prompts, te1["vocab_size"], None, self.device)
        ids2 = text.token_ids(prompts, te2["vocab_size"], 0, self.device)
        pen1, _ = self.models["text_encoder"](ids1)
        pen2, pooled = self.models["text_encoder_2"](ids2)
        return torch.cat([pen1, pen2], dim=-1), pooled

    @torch.no_grad()
    def edit(self, images_u8: torch.Tensor, prompts: list, guidance: float, seed: int,
             tile_noise: bool) -> torch.Tensor:
        """uint8 [B, r, r, 3] -> the edited images before rounding, fp32
        [B, r, r, 3] on the 0..255 scale (``clamp(x / 2 + 0.5, 0, 1) * 255``)."""
        with true_fp32():
            return self._edit(images_u8.to(self.device), prompts, guidance, seed, tile_noise)

    def _edit(self, images_u8, prompts, guidance, seed, tile_noise):
        cfg, e = self.cfg, self.cfg["edit"]
        m = self.models
        b, r = images_u8.shape[0], images_u8.shape[1]
        cfg_on = guidance > 1.0
        ctx, pooled = self._encode(list(prompts))
        if cfg_on:
            ctx_u, pooled_u = self._encode([e["negative_prompt"]])
            ctx = torch.stack([ctx_u.expand_as(ctx), ctx], 1).reshape(2 * b, *ctx.shape[1:])
            pooled = torch.stack([pooled_u.expand_as(pooled), pooled], 1).reshape(2 * b, -1)
        rows = ctx.shape[0]
        time_ids = torch.tensor([[r, r, 0, 0, r, r]], dtype=torch.float32,
                                device=self.device).repeat(rows, 1)

        control = canny.edges(images_u8, e["canny_low_threshold"], e["canny_high_threshold"])
        control = control.float()[:, None].expand(b, 3, r, r)
        if cfg["control_resolution"] != r:
            size = (cfg["control_resolution"],) * 2
            control = F.interpolate(control, size=size, mode="nearest-exact")
        pixels = (images_u8.float() / 127.5 - 1.0).permute(0, 3, 1, 2)

        steps = schedule.tables(cfg["scheduler"], e["num_inference_steps"], e["strength"])
        lat_hw = r // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        shape = (1 if tile_noise and b > 1 else b, lat_hw, lat_hw, cfg["vae"]["latent_channels"])
        draws = [torch.randn(shape, generator=gen, device=self.device).permute(0, 3, 1, 2)
                 for _ in range(len(steps) + 2)]
        eps_enc, noise_init, step_noise = draws[0], draws[1], draws[2:]

        sf = cfg["vae"]["scaling_factor"]
        mean, logvar = m["vae"].moments(pixels)
        lat = (mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * eps_enc) * sf
        lat = steps[0]["sqrt_a"] * lat + steps[0]["sqrt_1ma"] * noise_init

        cond = m["controlnet"].controlnet_cond_embedding(control)
        if cfg_on:
            cond = cond.repeat_interleave(2, dim=0)
        for i, s in enumerate(steps):
            x = lat.repeat_interleave(2, dim=0) if cfg_on else lat
            t = torch.full((rows,), s["t"], device=self.device)
            down, mid = m["controlnet"](x, t, ctx, pooled, time_ids, cond,
                                        e["controlnet_conditioning_scale"])
            eps = m["unet"](x, t, ctx, pooled, time_ids, down, mid)
            if cfg_on:
                eps_u, eps_c = eps[0::2], eps[1::2]
                eps = eps_u + guidance * (eps_c - eps_u)
            x0 = (lat - s["sqrt_1ma"] * eps) / s["sqrt_a"]
            lat = s["c_out"] * x0 + s["c_skip"] * lat
            if not s["last"]:
                lat = s["sqrt_a_prev"] * lat + s["sqrt_1ma_prev"] * step_noise[i]
        out = []
        for i in range(b):
            img = m["vae"].decode(lat[i:i + 1] / sf)
            out.append((img / 2 + 0.5).clamp(0.0, 1.0) * 255.0)
        return torch.cat(out).permute(0, 2, 3, 1)


def to_uint8(images: torch.Tensor) -> torch.Tensor:
    """The reference's images rounded as the program rounds its output."""
    return (images + 0.5).to(torch.uint8)
