"""GroupNorm (+ SiLU) over NHWC: CUDA kernel wrapper and its plain version.

The kernel (``csrc/group_norm.cu``) replaces the TPU kernel
``fastedit_tpu/ops/fused_groupnorm.py`` (``fused_group_norm`` ->
``_fused_gn_4d``): per-group sums, then the centred sum of squares (the
two-pass variance), then normalise + affine + optional SiLU with one
rounding to bf16.  The TPU kernel carries its sums across grid steps in
scratch; on the card each phase is a launch and the cross-block reduction
goes through a small fp32 workspace, summed in a fixed order.  Opt-in, as
in the JAX package (``flags.use_cuda_groupnorm``).
"""

from __future__ import annotations

from typing import Optional

import torch

from fastedit_tpu_torch.ops.groupnorm import group_norm_plain

# Launches of the CUDA kernel since the last reset (chip_smoke.py resets it).
launches = 0
MAX_CHANNELS = 4096  # two 8-channel vectors per thread of a 256-thread block
MAX_GROUPS = 128
BLOCKS_PER_CALL = 1024  # pixel chunks x batch items in each reduction launch


def supports(shape, num_groups: int) -> bool:
    """NHWC 4-D, C % G == 0 and G <= 128 (the JAX package's conditions;
    its VMEM budget admits every main-path shape and does not carry over),
    and C % 8 == 0, C <= 4096 (16-byte vectors, at most two per thread)."""
    if len(shape) != 4:
        return False
    c = shape[-1]
    return (c % num_groups == 0 and num_groups <= MAX_GROUPS and c % 8 == 0
            and c <= MAX_CHANNELS)


def fused_group_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
    act: Optional[str] = None,
) -> torch.Tensor:
    """x [B, H, W, C] bf16, gamma/beta [C] -> GroupNorm(x) (+ SiLU), bf16.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if x.device.type == "cpu":
        return group_norm_plain(x, gamma, beta, num_groups, eps, act)
    if act not in (None, "silu"):
        raise ValueError(f"unsupported activation {act!r}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"group_norm kernel takes bf16; got {x.dtype}")
    if not supports(tuple(x.shape), num_groups):
        raise ValueError(f"group_norm kernel does not take {tuple(x.shape)}, G={num_groups}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("group_norm: x must be a contiguous, 16-byte aligned NHWC tensor")
    b, h, w, c = x.shape
    gamma, beta = gamma.float().contiguous(), beta.float().contiguous()
    if gamma.shape != (c,) or beta.shape != (c,) or gamma.device != x.device \
            or beta.device != x.device:
        raise ValueError(f"group_norm: gamma and beta must be [{c}] on {x.device}")
    nchunk = max(1, min(h * w, BLOCKS_PER_CALL // b))
    work = torch.empty(2 * b * (nchunk + 1) * num_groups, dtype=torch.float32,
                       device=x.device)
    out = torch.empty_like(x)
    from fastedit_tpu_torch.ops.build import library

    fn = library("group_norm").group_norm_bf16
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), work.data_ptr(),
            b, h * w, c, num_groups, nchunk, float(eps), int(act == "silu"),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"group_norm kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out
