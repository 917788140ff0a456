"""OpenCV's Canny on uint8 RGB images, in plain PyTorch integer arithmetic:
the ControlNet's conditioning image.

Gray by cv2's fixed point ``(R*9798 + G*19235 + B*3735 + 2^14) >> 15``; 3x3
Sobel with the border replicated; L1 magnitude; non-maximum suppression by
cv2's integer sector test (tan 22.5 degrees as 13573 / 2^15) and its tie
rules; thresholds floored and ordered, compared strictly; hysteresis as the
candidates 8-connected to a strong pixel, grown to a fixed point.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _window(x: torch.Tensor, replicate: bool):
    """at(dy, dx)[b, y, x] = x[b, y + dy, x + dx], the border replicated or 0."""
    h, w = x.shape[-2:]
    p = F.pad(x[:, None].double(), (1, 1, 1, 1), mode="replicate" if replicate else "constant")
    p = p[:, 0].long()

    def at(dy, dx):
        return p[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    return at


def edges(images_u8: torch.Tensor, low, high) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> bool [B, H, W]."""
    lo, hi = sorted((math.floor(float(low)), math.floor(float(high))))
    u = images_u8.long()
    gray = (u[..., 0] * 9798 + u[..., 1] * 19235 + u[..., 2] * 3735 + (1 << 14)) >> 15
    g = _window(gray, replicate=True)
    gx = (g(-1, 1) - g(-1, -1)) + 2 * (g(0, 1) - g(0, -1)) + (g(1, 1) - g(1, -1))
    gy = (g(1, -1) - g(-1, -1)) + 2 * (g(1, 0) - g(-1, 0)) + (g(1, 1) - g(-1, 1))
    mag = gx.abs() + gy.abs()
    m = _window(mag, replicate=False)
    ax, ay = gx.abs(), gy.abs() * (1 << 15)
    tg22 = ax * 13573
    tg67 = tg22 + 2 * ax * (1 << 15)
    horizontal = (mag > m(0, -1)) & (mag >= m(0, 1))
    vertical = (mag > m(-1, 0)) & (mag >= m(1, 0))
    diag_same = (mag > m(-1, -1)) & (mag > m(1, 1))
    diag_opp = (mag > m(-1, 1)) & (mag > m(1, -1))
    opposite_signs = (gx < 0) != (gy < 0)
    keep = torch.where(ay < tg22, horizontal,
                       torch.where(ay > tg67, vertical,
                                   torch.where(opposite_signs, diag_opp, diag_same)))
    candidate = keep & (mag > lo)
    grown = candidate & (mag > hi)
    cand = candidate.float()[:, None]
    while True:
        nxt = (F.max_pool2d(grown.float()[:, None], 3, stride=1, padding=1) * cand)[:, 0] > 0
        if torch.equal(nxt, grown):
            return grown
        grown = nxt
