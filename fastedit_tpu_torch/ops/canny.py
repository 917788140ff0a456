"""Canny edge detection on the device, in integer fixed point.

Bit-exact to the JAX package's ``canny_np`` (and so to cv2 5.0):
  * RGB -> gray with cv2's shift-15 fixed point:
    ``(R*9798 + G*19235 + B*3735 + 2^14) >> 15``;
  * 3x3 Sobel on integers with replicate border, L1 magnitude, thresholds
    floored (and swapped if low > high), compared strictly;
  * non-maximum suppression with cv2's integer sector test (TG22 = 13573,
    shift 15) and its tie rules: horizontal keeps on ``m > left and
    m >= right``, vertical on ``m > up and m >= down``, diagonals strict on
    both sides, the diagonal chosen by the sign bit of ``gx ^ gy``;
  * double threshold and 8-connected hysteresis, grown by masked dilation
    to a fixed point (the same fixed point as cv2's flood fill).
Works on one image [H, W, 3] or a batch [B, H, W, 3].

:func:`canny_np` is the same algorithm in plain numpy with a stack-based
flood fill for the hysteresis, the port's own copy of the JAX package's
reference (``tools/conformance.py`` holds the card to it bit for bit).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_GRAY_COEF = (9798, 19235, 3735)
_GRAY_SHIFT = 15
_CANNY_SHIFT = 15
_TG22 = 13573


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] in [0, 255] -> [..., H, W] int32, cv2 rounding."""
    u = torch.round(img).int() if img.is_floating_point() else img.int()
    acc = (
        u[..., 0] * _GRAY_COEF[0]
        + u[..., 1] * _GRAY_COEF[1]
        + u[..., 2] * _GRAY_COEF[2]
        + (1 << (_GRAY_SHIFT - 1))
    )
    return acc >> _GRAY_SHIFT


def _shifts(x: torch.Tensor, replicate: bool):
    """sh(dy, dx)[..., y, x] = x[..., y+dy, x+dx], edge-replicated or zero."""
    h, w = x.shape[-2:]
    if replicate:
        rows = torch.arange(-1, h + 1, device=x.device).clamp(0, h - 1)
        cols = torch.arange(-1, w + 1, device=x.device).clamp(0, w - 1)
        p = x[..., rows, :][..., :, cols]
    else:
        p = F.pad(x, (1, 1, 1, 1))

    def sh(dy, dx):
        return p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    return sh


def _hysteresis(strong: torch.Tensor, weak: torch.Tensor) -> torch.Tensor:
    """Grow strong edges through 8-connected weak pixels to a fixed point,
    8 dilation steps between convergence checks."""
    cur = strong
    weak_f = weak.float()
    while True:
        grown = cur.float()
        for _ in range(8):
            dil = F.max_pool2d(grown[:, None], 3, stride=1, padding=1)[:, 0]
            grown = torch.maximum(dil * weak_f, grown)
        grown = grown > 0
        if torch.equal(grown, cur):
            return cur
        cur = grown


def canny(image: torch.Tensor, low_threshold=100.0, high_threshold=200.0) -> torch.Tensor:
    """cv2-exact Canny. image: [H, W, 3] or [B, H, W, 3] in [0, 255].
    Returns uint8 edges in {0, 255}, [H, W] or [B, H, W]."""
    single = image.dim() == 3
    gray = rgb_to_gray(image[None] if single else image)
    low = int(torch.floor(torch.tensor(float(low_threshold))))
    high = int(torch.floor(torch.tensor(float(high_threshold))))
    low, high = min(low, high), max(low, high)

    sh = _shifts(gray, replicate=True)
    gx = (sh(-1, 1) - sh(-1, -1)) + 2 * (sh(0, 1) - sh(0, -1)) + (sh(1, 1) - sh(1, -1))
    gy = (sh(1, -1) - sh(-1, -1)) + 2 * (sh(1, 0) - sh(-1, 0)) + (sh(1, 1) - sh(-1, 1))
    mag = gx.abs() + gy.abs()

    ax = gx.abs()
    ay = gy.abs() << _CANNY_SHIFT
    tg22x = ax * _TG22
    tg67x = tg22x + ((2 * ax) << _CANNY_SHIFT)
    m = _shifts(mag, replicate=False)
    horiz = ay < tg22x
    vert = ay > tg67x
    s_neg = torch.bitwise_xor(gx, gy) < 0
    keep_h = (mag > m(0, -1)) & (mag >= m(0, 1))
    keep_v = (mag > m(-1, 0)) & (mag >= m(1, 0))
    keep_d1 = (mag > m(-1, -1)) & (mag > m(1, 1))
    keep_d2 = (mag > m(-1, 1)) & (mag > m(1, -1))
    keep = torch.where(
        horiz, keep_h, torch.where(vert, keep_v, torch.where(s_neg, keep_d2, keep_d1))
    )
    cand = keep & (mag > low)
    strong = cand & (mag > high)
    edges = (_hysteresis(strong, cand).to(torch.uint8) * 255)
    return edges[0] if single else edges


def canny_np(
    image: np.ndarray, low_threshold=100.0, high_threshold=200.0
) -> np.ndarray:
    """Same cv2-exact algorithm in plain numpy (BFS hysteresis)."""
    img = np.asarray(image)
    if img.ndim == 3:
        u = np.round(img).astype(np.int64) if np.issubdtype(
            img.dtype, np.floating
        ) else img.astype(np.int64)
        acc = (
            u[..., 0] * _GRAY_COEF[0]
            + u[..., 1] * _GRAY_COEF[1]
            + u[..., 2] * _GRAY_COEF[2]
            + (1 << (_GRAY_SHIFT - 1))
        )
        gray = (acc >> _GRAY_SHIFT).astype(np.int32)
    elif np.issubdtype(img.dtype, np.floating):
        gray = np.round(img).astype(np.int32)
    else:
        gray = img.astype(np.int32)
    low = int(np.floor(low_threshold))
    high = int(np.floor(high_threshold))
    if low > high:
        low, high = high, low

    g = np.pad(gray, 1, mode="edge")
    h, w = gray.shape

    def sh(dy, dx):
        return g[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    gx = (sh(-1, 1) - sh(-1, -1)) + 2 * (sh(0, 1) - sh(0, -1)) + (sh(1, 1) - sh(1, -1))
    gy = (sh(1, -1) - sh(-1, -1)) + 2 * (sh(1, 0) - sh(-1, 0)) + (sh(1, 1) - sh(-1, 1))
    mag = np.abs(gx) + np.abs(gy)

    ax = np.abs(gx)
    ay = np.abs(gy) << _CANNY_SHIFT
    tg22x = ax * _TG22
    tg67x = tg22x + ((2 * ax) << _CANNY_SHIFT)
    m = np.pad(mag, 1)

    def shm(dy, dx):
        return m[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    horiz = ay < tg22x
    vert = ay > tg67x
    s_neg = np.bitwise_xor(gx, gy) < 0
    keep_h = (mag > shm(0, -1)) & (mag >= shm(0, 1))
    keep_v = (mag > shm(-1, 0)) & (mag >= shm(1, 0))
    keep_d1 = (mag > shm(-1, -1)) & (mag > shm(1, 1))
    keep_d2 = (mag > shm(-1, 1)) & (mag > shm(1, -1))
    keep = np.where(
        horiz, keep_h, np.where(vert, keep_v, np.where(s_neg, keep_d2, keep_d1))
    )

    cand = keep & (mag > low)
    strong = cand & (mag > high)
    # BFS from strong pixels through candidate ones.
    visited = strong.copy()
    stack = list(zip(*np.nonzero(strong)))
    while stack:
        y, x = stack.pop()
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ny, nx = y + dy, x + dx
                if 0 <= ny < h and 0 <= nx < w and cand[ny, nx] and not visited[ny, nx]:
                    visited[ny, nx] = True
                    stack.append((ny, nx))
    return (visited * 255).astype(np.uint8)
