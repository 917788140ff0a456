"""SSIM, PSNR and MSE in fp32 (a port of the JAX package's
``metrics/functional.py``).

Numerical equivalents of the torchmetrics calls the reference makes
(src/metrics.py:174-194):
  * SSIM: Gaussian 11-tap window, sigma 1.5, k1 = 0.01, k2 = 0.03,
    data_range 1, valid region (no padding), mean over the map;
  * PSNR: 10 log10(data_range^2 / MSE);
  * MSE: mean squared error.

Inputs are [B, H, W, C] (NHWC) floats in [0, 1].  By default each returns
one number over the batch, as the reference's calls do; ``per_image=True``
returns one per image [B] (the batched calculator).  On the card the blur's
convs must run in true fp32: under TF32 the moments cancel in sigma = E[x^2]
- mu^2 (the JAX package saw SSIM 12.8 instead of 0.457 so on its
accelerator), so callers run these inside ``calculator.true_fp32()``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel(kernel_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """1-D Gaussian, normalised to sum 1 (torchmetrics' window)."""
    coords = np.arange(kernel_size, dtype=np.float64) - (kernel_size - 1) / 2.0
    g = np.exp(-(coords**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _mean(x: torch.Tensor, per_image: bool) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.dim()))) if per_image else x.mean()


def ssim(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03,
         per_image: bool = False) -> torch.Tensor:
    x, y = img1.float(), img2.float()
    b, h, w, c = x.shape
    win = torch.from_numpy(_gaussian_kernel(kernel_size, sigma)).to(x.device)
    kh, kw = win.view(1, 1, kernel_size, 1), win.view(1, 1, 1, kernel_size)

    def blur(t: torch.Tensor) -> torch.Tensor:  # separable, depthwise, valid
        t = t.permute(0, 3, 1, 2).reshape(b * c, 1, h, w)
        t = F.conv2d(F.conv2d(t, kh), kw)
        return t.reshape(b, c, *t.shape[-2:]).permute(0, 2, 3, 1)

    mu_x, mu_y = blur(x), blur(y)
    sigma_x = blur(x * x) - mu_x * mu_x
    sigma_y = blur(y * y) - mu_y * mu_y
    sigma_xy = blur(x * y) - mu_x * mu_y
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
    return _mean(num / den, per_image)


def mse(img1: torch.Tensor, img2: torch.Tensor, per_image: bool = False) -> torch.Tensor:
    return _mean((img1.float() - img2.float()).square(), per_image)


def psnr(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0,
         per_image: bool = False) -> torch.Tensor:
    return 10.0 * torch.log10(data_range**2 / mse(img1, img2, per_image))
