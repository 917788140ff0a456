"""How the plain reference computes its products: in fp32 with TF32 off, or,
for the control of ``correct``, with every operand of every product rounded
to a lower precision first.

``"fp32"`` is the reference.  ``"tf32"`` rounds each operand to TF32's 10
explicit mantissa bits (round to nearest even) and ``"fp8"`` to float8 e4m3
with one scale per tensor (its largest magnitude to 448), then multiplies in
fp32: the step below fp32 and the step below bf16.  The rounding is written
out, not left to the card's TF32 switch, so a control computes the same on
the CPU and on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MODES = ("fp32", "tf32", "fp8")
_E4M3_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` with its mantissa rounded to 10 bits, to nearest even."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` through float8 e4m3 with one scale for the tensor."""
    xf = x.float()
    scale = xf.abs().amax().clamp(min=1e-30) / _E4M3_MAX
    return (xf / scale).to(torch.float8_e4m3fn).float() * scale


class Numerics:
    """The products of the reference: ``linear``, ``conv`` and ``attention``."""

    def __init__(self, mode: str = "fp32"):
        if mode not in MODES:
            raise ValueError(f"numerics mode {mode!r} not in {MODES}")
        self.mode = mode

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "tf32":
            return round_tf32(x)
        if self.mode == "fp8":
            return round_fp8(x)
        return x.float()

    def linear(self, x, weight, bias=None):
        return F.linear(self.operand(x), self.operand(weight), bias)

    def conv(self, x, weight, bias=None, stride: int = 1, padding: int = 1):
        return F.conv2d(self.operand(x), self.operand(weight), bias, stride=stride,
                        padding=padding)

    def attention(self, q, k, v, causal: bool = False):
        """q, k, v [B, H, S, D] -> [B, H, Sq, D], softmax scale D^-0.5."""
        return F.scaled_dot_product_attention(
            self.operand(q), self.operand(k), self.operand(v), is_causal=causal)
