"""GroupNorm (+ optional fused SiLU) for NHWC tensors, fp32 statistics.

Both functions use the two-pass variance, mean((x - mean)^2): the one-pass
E[x^2] - E[x]^2 form cancels in fp32 when |mean| >> std, which happens in
the late VAE decoder blocks.  :func:`group_norm` dispatches to the
GroupNorm kernel (``ops/fused_groupnorm.py``) wherever its gate admits the
call (``flags.takes``), as the JAX package's does where its flag turns the
kernel on (on in every stage of the port's plan, opt-in there).
:func:`group_norm_scale_shift`, which feeds the fused resnet conv's
prologue (XLA in the JAX package), dispatches in the same way to the
kernel's statistics launch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from fastedit_tpu_torch.ops import flags


def group_norm_plain(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
    act: Optional[str] = None,
) -> torch.Tensor:
    """x: [..., H, W, C] (NHWC); gamma/beta: [C]; act in {None, 'silu'}.
    The GroupNorm kernel's plain version, and PyTorch's GroupNorm outside
    the kernel's gate."""
    *lead, h, w, c = x.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    xf = x.float().reshape(*lead, h, w, num_groups, c // num_groups)
    dims = (len(lead), len(lead) + 1, len(lead) + 3)
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + eps)).reshape(*lead, h, w, c)
    out = out * gamma.float() + beta.float()
    if act == "silu":
        out = F.silu(out)
    elif act is not None:
        raise ValueError(f"unsupported activation {act!r}")
    return out.to(x.dtype)


def group_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
    act: Optional[str] = None,
) -> torch.Tensor:
    """Dispatching GroupNorm entry point used by all models."""
    from fastedit_tpu_torch.ops import fused_groupnorm as k  # it imports this module

    fn = group_norm_plain
    if flags.takes("group_norm", tuple(x.shape), num_groups):
        fn = flags.kernel_or_plain(k.fused_group_norm, group_norm_plain)
    return fn(x, gamma, beta, num_groups=num_groups, eps=eps, act=act)


def group_norm_scale_shift(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``(scale, shift)`` [B, C] with GN(x) == x * scale + shift: the
    prologue half of the fused resnet conv (``ops/conv_fused.py``)."""
    from fastedit_tpu_torch.ops import fused_groupnorm as k  # it imports this module

    fn = group_norm_scale_shift_plain
    if flags.takes("group_norm_scale_shift", tuple(x.shape), num_groups):
        fn = flags.kernel_or_plain(k.group_norm_scale_shift, group_norm_scale_shift_plain)
    return fn(x, gamma, beta, num_groups=num_groups, eps=eps)


def group_norm_scale_shift_plain(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The statistics launch's plain version, and the op outside the
    kernel's gate: the same two-pass statistics as :func:`group_norm_plain`."""
    b, h, w, c = x.shape
    g = num_groups
    if c % g:
        raise ValueError(f"channels {c} not divisible by groups {g}")
    xf = x.float().reshape(b, h * w, g, c // g)
    mean = xf.mean(dim=(1, 3))  # [B, G]
    var = (xf - mean[:, None, :, None]).square().mean(dim=(1, 3))
    rstd = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(c // g, dim=1)
    rstd_c = rstd.repeat_interleave(c // g, dim=1)
    scale = rstd_c * gamma.float()[None, :]
    shift = beta.float()[None, :] - mean_c * scale
    return scale, shift
