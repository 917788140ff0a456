"""Flash attention (BSHD): CUDA kernel wrapper and its plain version.

The kernel (``csrc/flash_attention.cu``) replaces both TPU kernels of
``fastedit_tpu/ops/flash_attention.py``: ``_flash_packed`` (two 64-dim
heads packed into 128 lanes, a TPU-only device) and ``_flash_bhsd`` (one
head per grid row, the VAE's single 512-dim head).  They compute one
function, so one CUDA kernel serves both, instantiated for D = 64 and
D = 512.
"""

from __future__ import annotations

from typing import Optional

import torch

# Head dims the kernel is instantiated for.
HEAD_DIMS = (64, 512)
# Launches of the CUDA kernel since the last reset, by head dim.
launches = {d: 0 for d in HEAD_DIMS}


def supports(q_shape, kv_len: int) -> bool:
    """The gate, as the JAX package's ``flash_attention.supports``: Sq and
    Skv at least 128 and multiples of 128 (the Pallas block picker's
    condition), D % 8 == 0, and a head dim the kernel is built for.  Calls
    outside it (cross-attention over 77 text tokens, the CLIP towers, the
    tiny model) take the plain path in ``ops/attention.py``."""
    if len(q_shape) != 4:
        return False
    sq, d = q_shape[1], q_shape[3]
    if sq < 128 or kv_len < 128 or sq % 128 or kv_len % 128:
        return False
    return d % 8 == 0 and d in HEAD_DIMS


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """q [B,Sq,H,D], k/v [B,Skv,H,D] -> [B,Sq,H,D]: fp32 logits and softmax,
    probabilities cast to v's dtype, fp32 accumulation (the JAX package's
    ``attention_xla``)."""
    d = q.shape[-1]
    scale = scale if scale is not None else d**-0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits * scale, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(
                f"flash_attention kernel takes bf16; {name} is {t.dtype} "
                "(fp32 quality mode is a later slice)"
            )
        if t.device != q.device:
            raise ValueError("flash_attention: q, k and v must be on one device")
        if t.dim() != 4 or t.stride(3) != 1 or t.stride(2) != t.shape[3]:
            raise ValueError(
                f"flash_attention: {name} must be BSHD with contiguous heads"
            )
        if t.stride(1) % 8 or t.stride(0) % 8 or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} rows must be 16-byte aligned")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not match"
        )
    if not supports(tuple(q.shape), k.shape[1]):
        raise ValueError(
            f"flash_attention kernel does not take q {tuple(q.shape)}, "
            f"kv length {k.shape[1]}"
        )


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """Flash attention, BSHD: q [B,Sq,H,D], k/v [B,Skv,H,D] -> [B,Sq,H,D].

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    d = q.shape[-1]
    scale = scale if scale is not None else d**-0.5
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    _check(q, k, v)
    from fastedit_tpu_torch.ops.build import library

    fn = library("flash_attention").flash_attention_bf16
    b, sq, h, _ = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, sq, k.shape[1], d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    launches[d] += 1
    return out
