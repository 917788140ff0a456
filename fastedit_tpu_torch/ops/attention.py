"""Dispatching scaled-dot-product attention, BSHD layout.

Layout ``[batch, seq, heads, head_dim]`` as in the JAX package.  UNet
self-attention (seq 4096 and 1024, 64-dim heads) and the VAE mid block
(seq 16384, one 512-dim head) reach the flash kernel; the UNet's
cross-attention to 77 text tokens in bf16 reaches the cross-attention kernel
(every key in one tile, ``flash_attention.supports_cross``), where the JAX
package sends it to XLA; fp32 cross-attention, the CLIP towers and the tiny
model's short sequences take the plain fp32 softmax path on any device, as
the JAX package sends them to XLA.  A call on the card with 128 q rows or
more that still takes that path is counted as ``attention.plain_on_card``
(``utils/profiling``).  ``flags.override(plain_versions=True)`` selects
their plain version in their place: the same plain function.
"""

from __future__ import annotations

from typing import Optional

import torch

from fastedit_tpu_torch.ops import flags
from fastedit_tpu_torch.ops import flash_attention as fa
from fastedit_tpu_torch.ops.flash_attention import attention_plain
from fastedit_tpu_torch.utils import profiling


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """q [B,Sq,H,D], k/v [B,Skv,H,D] -> [B,Sq,H,D]."""
    if flags.takes("flash_attention", tuple(q.shape), k.shape[1]):
        return flags.kernel_or_plain(fa.flash_attention, attention_plain)(q, k, v, scale=scale)
    if flags.takes("cross_attention", tuple(q.shape), k.shape[1], q.dtype):
        return flags.kernel_or_plain(fa.cross_attention, attention_plain)(q, k, v, scale=scale)
    if q.is_cuda and q.shape[1] >= 128:
        profiling.count("attention.plain_on_card")
    return attention_plain(q, k, v, scale=scale)
