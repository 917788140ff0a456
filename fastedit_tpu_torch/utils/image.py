"""Host-side image helpers: PIL <-> arrays, LANCZOS resize conventions.

Resize conventions mirror the reference exactly: inputs resized to the model
resolution with PIL LANCZOS (src/pipeline.py:251), metrics computed at
512x512 LANCZOS (src/metrics.py:226-231, evaluate.py:127-130).
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def pil_to_float(img: Image.Image) -> np.ndarray:
    """PIL RGB -> [H, W, 3] float32 in [0, 1]."""
    return np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0


def float_to_pil(arr: np.ndarray) -> Image.Image:
    """[H, W, 3] float in [0, 1] -> PIL RGB (uint8, round-half-away like PIL)."""
    arr = np.clip(np.asarray(arr, dtype=np.float32), 0.0, 1.0)
    return Image.fromarray((arr * 255.0 + 0.5).astype(np.uint8))


def resize(img: Image.Image, size: int | tuple[int, int]) -> Image.Image:
    if isinstance(size, int):
        size = (size, size)
    if img.size == tuple(size):
        return img
    return img.resize(size, Image.LANCZOS)
