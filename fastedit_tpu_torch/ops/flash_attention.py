"""Flash attention (BSHD): CUDA kernel wrapper and its plain version.

The kernel (``csrc/flash_attention.cu``) replaces both TPU kernels of
``fastedit_tpu/ops/flash_attention.py``: ``_flash_packed`` (two 64-dim
heads packed into 128 lanes, a TPU-only device) and ``_flash_bhsd`` (one
head per grid row, the VAE's single 512-dim head).  They compute one
function, so one C function serves both, with a kernel for D = 64 (``wgmma``,
TMA, a producer warp and two or three consumer warpgroups, persistent blocks)
and one for D = 512 (``mma.sync``, one block per tile).  The schedule is decided here,
by :func:`plan`: the q and KV tiles, the ring depth, the grid, the shared
memory and (``tile_at``) the order of the tiles.  :func:`attention_tiled_plain` walks the
same schedule in plain PyTorch, for the tests.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch

from fastedit_tpu_torch.ops.conv3x3 import H100_SMS, sm_count_of

# Head dims the kernel is instantiated for.
HEAD_DIMS = (64, 512)
# Launches of the CUDA kernel since the last reset, by head dim.
launches = {d: 0 for d in HEAD_DIMS}

# The kernels' geometry (csrc/flash_attention.cu holds the same constants):
# head dim -> (KV tile, KV stages, Q stages, persistent blocks).
GEOMETRY = {64: (128, 4, 2, True), 512: (32, 1, 1, False)}
# q tiles.  At D = 64 a consumer warpgroup owns a slice of 64 q rows and the
# library has instances with two and three of them: tiles of 128 and 192 rows.
# A row costs less in the larger tile (three warpgroups keep the tensor cores
# and the exp unit busier than two: 496-502 against 474-477 TFLOP/s at
# (4, 4096, 10, 64) on an H100 at 700 W, ``tools/attention_bench.py``), so
# :func:`plan` weighs the rounds of tiles a call needs by it.
SLICE = 64
Q_TILES = {64: (128, 192), 512: (32,)}
ROW_COST = {32: 1.0, 128: 1.0, 192: 0.93}


@dataclass(frozen=True)
class AttentionPlan:
    """The schedule of one flash attention call."""

    bq: int  # q rows per tile
    bkv: int  # keys per KV tile
    stages: int  # K and V tiles in flight, each
    q_tiles: int  # q tiles per (batch, head)
    kv_tiles: int  # KV tiles each q tile walks
    tiles: int  # all tiles: B * H * q_tiles
    grid: int  # blocks; persistent: block i walks tiles i, i + grid, ...
    persistent: bool
    smem_bytes: int  # dynamic shared memory
    box: tuple[int, int, int, int]  # TMA box over q / k / v (d, head, row, batch)
    heads: int

    def tile_at(self, t):
        """(batch, head, first q row) of tile ``t`` of the kernel's walk, q
        tile fastest, then the head, then the batch (``tile_at`` in
        csrc/flash_attention.cu).  ``t`` may be an integer array."""
        bh, qt = t // self.q_tiles, t % self.q_tiles
        return bh // self.heads, bh % self.heads, qt * self.bq


def smem_bytes(d: int, bq: Optional[int] = None) -> int:
    """Dynamic shared memory of the kernel for head dim ``d`` (and q tile
    ``bq``, where it has more than one instance).  D = 64: 1024 bytes of
    alignment slack, the Q ring, the K and V rings (rows of 128 bytes) and the
    mbarriers.  D = 512: the Q, K and V tiles (rows padded by 8), S in fp32
    (rows padded by 4), P in bf16 (rows padded by 8) and three fp32 vectors of
    the q tile's length."""
    bkv, stages, q_stages, _ = GEOMETRY[d]
    bq = Q_TILES[d][-1] if bq is None else bq
    if d == 64:
        return (1024 + (q_stages * bq + 2 * stages * bkv) * d * 2
                + 8 * (2 * q_stages + 4 * stages))
    return 2 * (bq + 2 * bkv) * (d + 8) + 4 * bq * (bkv + 4) + 2 * bq * (bkv + 8) + 4 * 3 * bq


@functools.lru_cache(maxsize=None)
def plan(b: int, sq: int, skv: int, h: int, d: int, sms: int = H100_SMS) -> AttentionPlan:
    """The kernel's schedule, a pure function of the call's shape (and the
    card's SM count, for the grid).  D = 64: tiles of 128 or 192 q rows (64
    for each of two or three consumer warpgroups; a head's last tile of 192
    may reach past Sq, a multiple of 64: the kernel's loads zero-fill and its
    stores clip there), whichever needs the cheaper rounds of tiles on this
    card: every block walks ceil(tiles / blocks) tiles, so 2 x 1024 rows x 20
    heads is three rounds of 128 rows or two of 192, and 2 x 4096 x 10 is five
    of 128 or four of 192.  KV tiles of 128 keys, four K and four V tiles in
    flight, one persistent block per SM at most; the tiles are walked q tile
    fastest, so the blocks that run together are the q tiles of a few heads
    and find those heads' K and V in L2 (heads fastest measured the same on an
    H100: K and V of a whole call fit its L2).  D = 512: one block per tile of 32 q rows, KV tiles of 32."""
    if d not in GEOMETRY:
        raise ValueError(f"flash attention plan: no kernel for head dim {d}")
    bkv, stages, _, persistent = GEOMETRY[d]
    row_unit = SLICE if d == 64 else Q_TILES[d][0]
    if min(b, h) < 1 or sq < row_unit or skv < bkv or sq % row_unit or skv % bkv:
        raise ValueError(f"flash attention plan: q rows {sq} and keys {skv} must be "
                         f"multiples of {row_unit} and {bkv}, batch {b} and heads {h} positive")

    def cost(bq):  # rounds of tiles x rows a tile x what a row costs in it
        return -(-(b * h * -(-sq // bq)) // sms) * bq * ROW_COST[bq]

    bq = min(Q_TILES[d], key=cost)
    q_tiles = -(-sq // bq)
    tiles = b * h * q_tiles
    return AttentionPlan(
        bq=bq, bkv=bkv, stages=stages, q_tiles=q_tiles, kv_tiles=skv // bkv, tiles=tiles,
        grid=min(tiles, sms) if persistent else tiles, persistent=persistent,
        smem_bytes=smem_bytes(d, bq), box=(d, 1, bq, 1), heads=h,
    )


def plan_for(q: torch.Tensor, kv_len: int) -> AttentionPlan:
    """The plan of a call on the card that holds ``q``."""
    b, sq, h, d = q.shape
    return plan(b, sq, kv_len, h, d, sm_count_of(q))


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


def attention_tiled_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None,
    kv_tiles_skipped: int = 0,
) -> torch.Tensor:
    """The kernel's schedule in plain PyTorch, for tests only: per tile of
    :func:`plan` the scale folded into q in q's dtype, then per KV tile the
    scores in fp32, the running max, the rescale of sum and output, P summed
    unrounded and rounded to v's dtype before P.V, and one rounding of O / l
    at the end.  It differs from ``attention_plain`` only in the order of the
    sums (and, in bf16, in where the scale rounds).  ``kv_tiles_skipped``
    plants a fault: the walk stops that many KV tiles short."""
    b, sq, h, d = q.shape
    scale = scale if scale is not None else d**-0.5
    pl = plan(b, sq, k.shape[1], h, d)
    out = torch.empty_like(q)
    for t in range(pl.tiles):
        bi, hi, q0 = pl.tile_at(t)
        rows = min(pl.bq, sq - q0)  # a head's last tile may reach past Sq
        qs = (q[bi, q0:q0 + rows, hi] * torch.tensor(scale, dtype=q.dtype)).float()
        m = torch.full((rows, 1), -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros((rows, 1), dtype=torch.float32, device=q.device)
        o = torch.zeros((rows, d), dtype=torch.float32, device=q.device)
        for j in range(pl.kv_tiles - kv_tiles_skipped):
            kt = k[bi, j * pl.bkv:(j + 1) * pl.bkv, hi].float()
            vt = v[bi, j * pl.bkv:(j + 1) * pl.bkv, hi]
            s = qs @ kt.T
            mx = torch.maximum(m, s.max(dim=1, keepdim=True).values)
            alpha, p = torch.exp(m - mx), torch.exp(s - mx)
            l = l * alpha + p.sum(dim=1, keepdim=True)
            o = o * alpha + p.to(vt.dtype).float() @ vt.float()
            m = mx
        out[bi, q0:q0 + rows, hi] = (o / l).to(q.dtype)
    return out


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
    pl = plan_for(q, k.shape[1])
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, sq, k.shape[1], d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), float(scale),
            pl.bq, pl.bkv, pl.grid, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    launches[d] += 1
    return out
