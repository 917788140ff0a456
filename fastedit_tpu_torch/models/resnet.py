"""ResNet blocks and resampling layers (NHWC) for UNet / ControlNet / VAE.

The conv modules dispatch as the JAX package's do (``models/resnet.py``
there), on the kernel plan of the stage they run in (``ops/flags.py``):
whole resnet blocks through the fused conv kernel, upsamplers through the
up2 kernel, downsamplers through the stride-2 kernel, each where the plan
has it and its gate admits the call (``flags.takes``), and op by op with
the same math otherwise.  Convs subclass ``nn.Conv2d`` so their parameters
keep PyTorch's names and OIHW shapes; their ``forward`` takes and returns
NHWC tensors.  What the kernels take derived from the weights (the bias in fp32,
the up2 kernel's folded phase weights, the fp32 kernels' TF32 hi and lo
weights: of the weight, or of the upsample conv's phase weights folded in
fp32) is made once per version of the weights
(:func:`_prepared`), not at every call, so a CUDA graph of a stage holds none
of it, and it outlives the graphs that read it: a new version drops them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from fastedit_tpu_torch.models.layers import GroupNorm
from fastedit_tpu_torch.ops import conv_fused, flags
from fastedit_tpu_torch.ops.conv import conv3x3_same


def _prepared(conv: nn.Conv2d, name: str, make):
    """``make()``, kept on ``conv`` and made again only when its weight or
    bias changed (another tensor, or written in place: ``load_state_dict``,
    a seeded init)."""
    key = tuple((t.data_ptr(), t._version) for t in (conv.weight, conv.bias) if t is not None)
    cache = conv.__dict__.setdefault("_prepared_cache", {})
    hit = cache.get(name)
    if hit is None or hit[0] != key:
        hit = cache[name] = (key, make())
    return hit[1]


def _bias_f32(conv: nn.Conv2d) -> torch.Tensor:
    """The bias in fp32, as the conv kernels read it."""
    return _prepared(conv, "bias_f32", lambda: conv.bias.float().contiguous())


def _tf32_split(conv: nn.Conv2d, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The TF32 hi and lo copies of ``w`` (``conv``'s weight in channels_last
    memory) that the fp32 kernels take on the card, split once per weight
    version."""
    return _prepared(conv, "tf32_split", lambda: conv_fused.split_tf32(w))


class Conv3x3(nn.Conv2d):
    """3x3 stride-1 SAME conv dispatched through ``ops.conv.conv3x3_same``
    (the conv kernel for Cin >= 64 where the stage's plan has it).

    Optional fused-resnet operands (``ops/conv_fused.conv3x3_fused``; each
    falls back to the same math op by op where the stage's plan lacks the
    fused kernel or its gate refuses the call):

    * ``prenorm``: fp32 ``(scale, shift)`` [B, Cin]; the input is mapped
      through ``silu(x * scale + shift)`` before the taps (GroupNorm + SiLU
      with the statistics precomputed, ``GroupNorm(scale_shift=True)``).
    * ``extra_bias``: [B, Cout] per-batch add (the time embedding).
    * ``skip``: [B, H, W, Cout] residual added after the bias.
    * ``up2``: nearest-2x upsample before the conv (``conv3x3_up2``: no
      materialised 4x tensor).

    In fp32 the stride-1 and the fused conv kernel take the weight's TF32 hi
    and lo copies, the upsample conv kernel those of its phase weights, each
    split at the first call that reaches it and kept until the weight changes.
    """

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, padding=1)

    def _up2(self, x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """The upsample conv kernel, on phase weights folded once per weight
        version (fp32: their TF32 hi and lo copies)."""
        if not x.is_cuda:
            return conv_fused.conv3x3_up2(x, w, bias=bias)
        if w.dtype == torch.float32:
            split = _prepared(self, "up2_tf32_split", lambda: conv_fused.split_up2(w))
            return conv_fused.conv3x3_up2(x, w, bias=bias, w_split=split)
        phases = _prepared(self, "up2_phases", lambda: conv_fused.fold_up2(w))
        return conv_fused.conv3x3_up2(x, w, bias=bias, phases=phases)

    def _fused(self, x: torch.Tensor, w: torch.Tensor, **kw) -> torch.Tensor:
        """The fused conv kernel; in fp32 on the card on the weight's TF32 hi
        and lo copies, split once per weight version."""
        split = _tf32_split(self, w) if x.is_cuda and w.dtype == torch.float32 else None
        return conv_fused.conv3x3_fused(x, w, w_split=split, **kw)

    def forward(
        self,
        x: torch.Tensor,
        prenorm: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
        extra_bias: Optional[torch.Tensor] = None,
        skip: Optional[torch.Tensor] = None,
        up2: bool = False,
    ) -> torch.Tensor:
        dtype = self.weight.dtype
        x = x.to(dtype).contiguous()
        w = self.weight.contiguous(memory_format=torch.channels_last)
        shapes = (tuple(x.shape), tuple(w.shape))

        bias = _bias_f32(self)

        def split():
            return _tf32_split(self, w)

        if up2:
            assert prenorm is None and extra_bias is None and skip is None
            if flags.takes("conv3x3_up2", *shapes):
                fn = flags.kernel_or_plain(self._up2, conv_fused.conv3x3_up2_plain)
                return fn(x, w, bias=bias)
            x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            return conv3x3_same(x, w, bias=bias, split=split)

        if prenorm is None and extra_bias is None and skip is None:
            return conv3x3_same(x, w, bias=bias, split=split)

        bias_eff = bias
        if extra_bias is not None:  # [B, Cout], summed in fp32
            bias_eff = bias[None, :] + extra_bias.float()
        if flags.takes("conv3x3_fused", *shapes):
            fn = flags.kernel_or_plain(self._fused, conv_fused.conv3x3_fused_plain)
            return fn(x, w, bias=bias_eff, prenorm=prenorm,
                      skip=None if skip is None else skip.to(dtype).contiguous())
        # Unfused fallback: the same math as the kernel, op by op.
        if prenorm is not None:
            x = conv_fused.prologue_plain(x, *prenorm)
        out = conv3x3_same(x, w, split=split)
        out = out + (bias_eff[:, None, None, :] if bias_eff.dim() == 2 else bias_eff).to(dtype)
        if skip is not None:
            out = out + skip.to(dtype)
        return out.to(dtype)


class Conv1x1(nn.Conv2d):
    """1x1 conv as a matmul over the channel dim."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.view(self.out_channels, self.in_channels)
        return F.linear(x.to(w.dtype), w, self.bias)


class StridedConv3x3(nn.Conv2d):
    """Stride-2 3x3 conv with torch's (1,1) padding, or the VAE encoder's
    asymmetric (0,1) padding: the stride-2 kernel (``conv3x3_down2``) where
    the stage's plan has it and its gate admits the call (``flags.takes``),
    PyTorch's strided conv otherwise."""

    def __init__(self, in_channels: int, out_channels: int, asymmetric: bool = False):
        super().__init__(in_channels, out_channels, 3, stride=2,
                         padding=0 if asymmetric else 1)
        self.asymmetric = asymmetric

    def _down2(self, x: torch.Tensor, w: torch.Tensor, **kw) -> torch.Tensor:
        """The stride-2 kernel; in fp32 on the card on the weight's TF32 hi
        and lo copies, split once per weight version."""
        split = _tf32_split(self, w) if x.is_cuda and w.dtype == torch.float32 else None
        return conv_fused.conv3x3_down2(x, w, w_split=split, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype).contiguous()
        w = self.weight.contiguous(memory_format=torch.channels_last)
        if flags.takes("conv3x3_down2", tuple(x.shape), tuple(w.shape)):
            fn = flags.kernel_or_plain(self._down2, conv_fused.conv3x3_down2_plain)
            return fn(x, w, bias=_bias_f32(self), asymmetric=self.asymmetric)
        x = x.permute(0, 3, 1, 2)
        if self.asymmetric:
            x = F.pad(x, (0, 1, 0, 1))
        out = F.conv2d(x, self.weight, stride=2, padding=self.padding)
        out = out + self.bias.to(out.dtype)[:, None, None]
        return out.permute(0, 2, 3, 1).contiguous()


class ResnetBlock2D(nn.Module):
    """GN+SiLU -> conv3x3 -> (+time emb) -> GN+SiLU -> conv3x3 -> +shortcut.

    Where the stage's plan has the fused conv and its gate admits both
    convs (``flags.takes``), the whole block runs as two fused convs: the
    GroupNorm statistics are plain reductions over the raw tensors, and the
    normalise + SiLU map, the time-embedding bias and the residual add ride
    inside the convs."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps=eps, act="silu")
        self.conv1 = Conv3x3(in_channels, out_channels)
        if temb_channels is not None:
            self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm(groups, out_channels, eps=eps, act="silu")
        self.conv2 = Conv3x3(out_channels, out_channels)
        self.conv_shortcut = (
            Conv1x1(in_channels, out_channels) if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None):
        t = None if temb is None else self.time_emb_proj(F.silu(temb))
        out_shape = (*x.shape[:-1], self.conv2.out_channels)
        if (flags.takes("conv3x3_fused", tuple(x.shape), tuple(self.conv1.weight.shape))
                and flags.takes("conv3x3_fused", out_shape, tuple(self.conv2.weight.shape))):
            shortcut = x if self.conv_shortcut is None else self.conv_shortcut(x)
            h = self.conv1(x, prenorm=self.norm1(x, scale_shift=True), extra_bias=t)
            return self.conv2(h, prenorm=self.norm2(h, scale_shift=True), skip=shortcut)

        h = self.conv1(self.norm1(x))
        if t is not None:
            h = h + t[:, None, None, :]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """Strided conv downsample; the VAE encoder pads (0,1)."""

    def __init__(self, channels: int, asymmetric_pad: bool = False):
        super().__init__()
        self.conv = StridedConv3x3(channels, channels, asymmetric=asymmetric_pad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest x2 then conv3x3: the up2 kernel where the stage's plan has
    it, the exact repeat and the plain conv dispatch otherwise."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv3x3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, up2=True)
