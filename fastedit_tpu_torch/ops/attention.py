"""Dispatching scaled-dot-product attention, BSHD layout.

Layout ``[batch, seq, heads, head_dim]`` as in the JAX package.  UNet
self-attention (seq 4096 and 1024, 64-dim heads) and the VAE mid block
(seq 16384, one 512-dim head) reach the flash kernel; cross-attention to
77 text tokens and the tiny model's short sequences take the plain fp32
softmax path on any device, as the JAX package sends them to XLA.
``flags.override(use_cuda_attention=False)`` turns the kernel off, and
``flags.override(plain_versions=True)`` selects its plain version in its
place; both run the same plain function.
"""

from __future__ import annotations

from typing import Optional

import torch

from fastedit_tpu_torch.ops import flags
from fastedit_tpu_torch.ops import flash_attention as fa
from fastedit_tpu_torch.ops.flash_attention import attention_plain


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """q [B,Sq,H,D], k/v [B,Skv,H,D] -> [B,Sq,H,D]."""
    if flags.use_cuda_attention() and fa.supports(tuple(q.shape), k.shape[1]):
        return flags.kernel_or_plain(fa.flash_attention, attention_plain)(q, k, v, scale=scale)
    return attention_plain(q, k, v, scale=scale)
