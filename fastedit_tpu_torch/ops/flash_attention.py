"""Flash attention (BSHD): CUDA kernel wrapper and its plain version.

The kernel (``csrc/flash_attention.cu``) replaces both TPU kernels of
``fastedit_tpu/ops/flash_attention.py``: ``_flash_packed`` (two 64-dim
heads packed into 128 lanes, a TPU-only device) and ``_flash_bhsd`` (one
head per grid row, the VAE's single 512-dim head).  They compute one
function, so one C function serves both, with a kernel for D = 64 (``wgmma``,
TMA, a producer warp and two or three consumer warpgroups, persistent blocks)
and one for D = 512 on the same parts, where O is too wide for one
warpgroup: one warpgroup computes S and the softmax of a 64-row q tile and
hands P through shared memory to two that own 256 columns of O each.  The
schedule is decided here, by :func:`plan`: the q and KV tiles, the ring
depths, the grid, the shared memory and (``tile_at``) the order of the tiles.
:func:`attention_tiled_plain` walks the same schedule in plain PyTorch, for
the tests.

Cross-attention to a short key sequence (the UNet's 77 text tokens), which
the flash gate leaves out: with bf16 q, k and v, D = 64 and every key in one
KV tile (:func:`supports_cross`), a call on the card launches
``flash_d64_kernel_cross`` (:func:`cross_attention`), one pass over q that
masks the padded keys, normalises P in fp32 before rounding it to bf16, as
:func:`attention_plain` does, and writes O once; :func:`plan_cross` is its
schedule (persistent blocks over q tiles walked heads fastest, so that the
blocks running together read whole rows of q) and
:func:`attention_cross_tiled_plain` walks it.  It has a launch counter of its
own (``cross_launches``).  fp32 calls keep the plain version.

fp32 (the quality mode): a CUDA fp32 call launches the 3xTF32 kernels of
``csrc/flash_attention_tf32x3.cu`` instead (every product as three TF32
products on ``wgmma``, after a launch that splits Q, K and V^T into hi and lo
copies in a scratch buffer): at D = 64 q tiles of 128 rows whose Q stays in
shared memory and P in registers, at D = 512 q tiles of 64 rows; KV tiles of
64 keys (:func:`plan_f32`; :func:`attention_tiled_plain_f32` walks it), with
launch counters of their own (``launches_f32``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch

from fastedit_tpu_torch.ops.conv3x3 import H100_SMS, check_dtypes, sm_count_of

# Head dims the kernel is instantiated for.
HEAD_DIMS = (64, 512)
# Launches of the CUDA kernel since the last reset, by head dim: bf16 and fp32.
launches = {d: 0 for d in HEAD_DIMS}
launches_f32 = {d: 0 for d in HEAD_DIMS}
# Launches of the cross-attention kernel (bf16 only) since the last reset.
cross_launches = 0

# The kernels' geometry (csrc/flash_attention.cu holds the same constants):
# head dim -> (KV tile, K ring stages, Q stages); the blocks are persistent.  At D = 64
# a ring stage is a KV tile and V's ring is as deep as K's.  At D = 512 a row
# is eight 128-byte swizzle rows, so a tile is eight column panels of 64
# elements (a 5-D tensor map lands a box panel by panel): a K stage is one
# panel of a KV tile (64 keys x 64 columns, 8 KB) and a V stage (V_RING) a slab
# of 16 keys x 512 columns (16 KB), half of it in the ring of each of the two
# warpgroups that multiply by V.
GEOMETRY = {64: (128, 4, 2), 512: (64, 6, 1)}
PANEL = 64  # columns of one TMA box: 128 bytes, one swizzle row
V_RING = {64: (4, 128), 512: (6, 16)}  # head dim -> (V ring stages, keys per stage)
P_STAGES = 2  # D = 512: P tiles in flight between the softmax and the PV warpgroups
PV_GROUPS = 2  # D = 512: warpgroups that own D / 2 columns of O each, with a V ring each
# q tiles.  At D = 64 a consumer warpgroup owns a slice of 64 q rows and the
# library has instances with two and three of them: tiles of 128 and 192 rows.
# A row costs less in the larger tile (three warpgroups keep the tensor cores
# and the exp unit busier than two: 496-502 against 474-477 TFLOP/s at
# (4, 4096, 10, 64) on an H100 at 700 W, ``tools/attention_bench.py``), so
# :func:`plan` weighs the rounds of tiles a call needs by it.
SLICE = 64
Q_TILES = {64: (128, 192), 512: (64,)}
ROW_COST = {64: 1.0, 128: 1.0, 192: 0.93}


@dataclass(frozen=True)
class AttentionPlan:
    """The schedule of one flash attention call."""

    bq: int  # q rows per tile
    bkv: int  # keys per KV tile
    stages: int  # the K ring: KV tiles (D = 64) or 64-column panels of one (D = 512)
    v_stages: int  # the V ring: stages of ``v_box`` keys (all columns)
    q_tiles: int  # q tiles per (batch, head)
    kv_tiles: int  # KV tiles each q tile walks
    tiles: int  # all tiles: B * H * q_tiles
    grid: int  # persistent blocks; block i walks tiles i, i + grid, ...
    smem_bytes: int  # dynamic shared memory
    # TMA boxes over q, k and v.  D = 64: (d, head, row, batch).  D = 512: (d
    # within a panel, row, panel, head, batch), which lands panel by panel.
    box: tuple[int, ...]
    k_box: tuple[int, ...]
    v_box: tuple[int, ...]
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
    mbarriers.  D = 512: the slack, Q (one stage), the K ring of panels, the V
    ring of slabs, two P tiles in bf16 with a row statistic in fp32 each, and
    the mbarriers (a full and an empty one per stage of Q, K, V and P)."""
    bkv, stages, q_stages = GEOMETRY[d]
    v_stages, v_rows = V_RING[d]
    bq = Q_TILES[d][-1] if bq is None else bq
    if d == 64:
        return (1024 + (q_stages * bq + 2 * stages * bkv) * d * 2
                + 8 * (2 * q_stages + 4 * stages))
    return (1024 + q_stages * bq * d * 2 + stages * bkv * PANEL * 2
            + v_stages * v_rows * d * 2
            + P_STAGES * (bq * bkv * 2 + bq * 4)
            + 8 * 2 * (q_stages + stages + PV_GROUPS * v_stages + P_STAGES))


def _q_tile(b: int, sq: int, h: int, d: int, sms: int) -> int:
    """The q tile whose rounds of tiles cost least on ``sms`` SMs: every block
    walks ceil(tiles / blocks) tiles, each of bq rows at ``ROW_COST[bq]``."""
    def cost(bq):
        return -(-(b * h * -(-sq // bq)) // sms) * bq * ROW_COST[bq]

    return min(Q_TILES[d], key=cost)


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
    H100: K and V of a whole call fit its L2).  D = 512: tiles of 64 q rows
    (their O, 64 x 512 in fp32, is half of an SM's registers, so no larger
    tile fits; 16384 rows are 256 tiles, two rounds of 132 blocks), KV tiles of
    64 keys, K streamed through a ring of six 64-column panels and V through
    six slabs of 16 keys, persistent blocks, q tile fastest."""
    if d not in GEOMETRY:
        raise ValueError(f"flash attention plan: no kernel for head dim {d}")
    bkv, stages, _ = GEOMETRY[d]
    v_stages, v_rows = V_RING[d]
    if min(b, h) < 1 or sq < SLICE or skv < bkv or sq % SLICE or skv % bkv:
        raise ValueError(f"flash attention plan: q rows {sq} and keys {skv} must be "
                         f"multiples of {SLICE} and {bkv}, batch {b} and heads {h} positive")

    bq = _q_tile(b, sq, h, d, sms)
    q_tiles = -(-sq // bq)
    tiles = b * h * q_tiles
    return AttentionPlan(
        bq=bq, bkv=bkv, stages=stages, v_stages=v_stages, q_tiles=q_tiles,
        kv_tiles=skv // bkv, tiles=tiles, grid=min(tiles, sms),
        smem_bytes=smem_bytes(d, bq), heads=h,
        **(dict(box=(PANEL, 1, bq, 1), k_box=(PANEL, 1, bkv, 1), v_box=(PANEL, 1, v_rows, 1))
           if d == PANEL else
           dict(box=(PANEL, bq, d // PANEL, 1, 1), k_box=(PANEL, bkv, 1, 1, 1),
                v_box=(PANEL, v_rows, d // PANEL // PV_GROUPS, 1, 1))),
    )


# The fp32 kernels (csrc/flash_attention_tf32x3.cu, 3xTF32 on wgmma; it holds the
# same constants), both after a split of Q, K and V^T into hi and lo copies.
# D = 64: q tiles of 128 rows (64 for each of two consumer warpgroups) whose Q
# in hi and lo stays in shared memory, KV tiles of 64 keys, K(j) and V(j)^T in
# turn through a ring of TF32X3_D64_STAGES stages of 32 KB (hi and lo of 64 keys
# x 64 columns), P in registers; V^T's keys are written in the order P's
# fragments take them (TF32X3_D64_KEY_ORDER: slot i of each group of eight
# holds key KEY_ORDER[i]).  D = 512: q tiles of 64 rows, KV tiles of 64 keys, Q
# and K streamed in hi and lo panels of 32 columns through a ring of
# QK_STAGES stages (4 x 8 KB), V^T's hi and lo through a ring of V_STAGES stages
# of 32 keys x 64 columns per PV warpgroup, P in fp32 two buffers deep.
# Persistent blocks, q tile fastest.
F32_TILES = {64: (128, 64), 512: (64, 64)}
TF32X3_D64_STAGES = 5
TF32X3_D64_KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
TF32X3_PANEL, TF32X3_QK_STAGES, TF32X3_V_STAGES, TF32X3_V_KEYS = 32, 3, 3, 32
# D = 512: P V runs in two passes over O's column halves; pass 0 writes P's A
# fragments of every KV tile (64 x 64 fp32) and the rows' rescale factors to a
# scratch of each block's own, pass 1 reads them back.
TF32X3_FRAG_FLOATS = 64 * 64


def smem_bytes_f32(d: int) -> int:
    """Dynamic shared memory of the fp32 kernel for head dim ``d``.  D = 64:
    alignment slack, Q's hi and lo copies (128 rows x 64 columns each), the ring
    (hi and lo of 64 keys x 64 columns a stage) and the mbarriers (a full and an
    empty one for Q and for each stage).  D = 512: alignment slack, the Q/K
    ring (hi and lo panels of 64 rows x 32 columns of each), both PV
    warpgroups' V rings (hi and lo of 32 keys x 64 columns), two P tiles of 64
    x 64 fp32 with a row statistic each, and a full and an empty mbarrier per
    stage of each ring and per P tile."""
    if d == 64:
        return (1024 + 2 * 128 * 64 * 4 + TF32X3_D64_STAGES * 2 * 64 * 64 * 4
                + 8 * 2 * (1 + TF32X3_D64_STAGES))
    tile = 64 * TF32X3_PANEL * 4
    return (1024 + TF32X3_QK_STAGES * 4 * tile + PV_GROUPS * TF32X3_V_STAGES * 2 * tile
            + P_STAGES * (64 * 64 * 4 + 64 * 4)
            + 8 * 2 * (TF32X3_QK_STAGES + PV_GROUPS * TF32X3_V_STAGES + P_STAGES))


@dataclass(frozen=True)
class AttentionPlanF32:
    """The schedule of one call of an fp32 kernel."""

    bq: int  # q rows per tile
    bkv: int  # keys per KV tile
    q_tiles: int  # q tiles per (batch, head)
    kv_tiles: int  # KV tiles each q tile walks
    tiles: int  # all tiles: B * H * q_tiles
    grid: int  # persistent blocks
    smem_bytes: int
    heads: int
    stages: int  # D = 64: the K / V ring; D = 512: the Q/K ring
    scratch_floats: int  # the hi and lo copies of Q, K and V^T (D = 512: and P's fragments)
    # D = 512: columns of a Q/K panel, the V rings' stages, keys of a V stage
    panel: int = 0
    v_stages: int = 0
    v_keys: int = 0
    # the keys of a group of eight in the order P V contracts them (D = 64)
    key_order: tuple[int, ...] = tuple(range(8))

    def tile_at(self, t):
        """(batch, head, first q row) of tile ``t``: q tile fastest, then
        the head, then the batch."""
        bh, qt = t // self.q_tiles, t % self.q_tiles
        return bh // self.heads, bh % self.heads, qt * self.bq


@functools.lru_cache(maxsize=None)
def plan_f32(b: int, sq: int, skv: int, h: int, d: int, sms: int = H100_SMS) -> AttentionPlanF32:
    """The fp32 kernels' schedule, a pure function of the shape (and the SM
    count): at most one persistent block per SM, q tile fastest; the scratch
    holds the hi and lo copies of Q, K and V^T.  D = 64: q tiles of 128 rows
    (Q in hi and lo, 64 KB, stays in shared memory for the walk over the keys;
    2 x 1024 rows x 20 heads is 320 tiles, 2.4 rounds of 132 blocks, and 2 x
    4096 x 10 is 640, 4.8 rounds), KV tiles of 64 keys.  D = 512: q tiles of 64
    rows (one wgmma's M; Q in hi and lo would be 256 KB, so it is streamed with
    K, panel by panel), KV tiles of 64 keys (16384 rows are 256 tiles, two
    rounds of 132 blocks); the scratch also holds, per block, P's fragments and
    rescale factors of a tile."""
    if d not in F32_TILES:
        raise ValueError(f"flash attention plan_f32: no kernel for head dim {d}")
    bq, bkv = F32_TILES[d]
    if min(b, h) < 1 or sq < bq or skv < bkv or sq % bq or skv % bkv:
        raise ValueError(f"flash attention plan_f32: q rows {sq} and keys {skv} must be "
                         f"multiples of {bq} and {bkv}, batch {b} and heads {h} positive")
    tiles = b * h * (sq // bq)
    grid = min(tiles, sms)
    copies = 2 * b * h * (sq + 2 * skv) * d
    common = dict(bq=bq, bkv=bkv, q_tiles=sq // bq, kv_tiles=skv // bkv, tiles=tiles,
                  grid=grid, smem_bytes=smem_bytes_f32(d), heads=h)
    if d == 64:
        return AttentionPlanF32(stages=TF32X3_D64_STAGES, scratch_floats=copies,
                                key_order=TF32X3_D64_KEY_ORDER, **common)
    return AttentionPlanF32(
        stages=TF32X3_QK_STAGES, panel=TF32X3_PANEL, v_stages=TF32X3_V_STAGES,
        v_keys=TF32X3_V_KEYS,
        scratch_floats=copies + grid * (skv // bkv) * (TF32X3_FRAG_FLOATS + bq), **common)


# The cross-attention kernel (csrc/flash_attention.cu ``flash_d64_kernel_cross``,
# which holds the same constants): every key in one KV tile of 80 keys (up to 80
# keys: one wgmma of N = 80) or 128 (up to 127), a ring of four Q tiles and one
# of four K / V tiles (a tile's K and V, unless its head is the previous tile's).
CROSS_KV_TILES = (80, 128)
CROSS_Q_STAGES, CROSS_KV_STAGES = 4, 4


def smem_bytes_cross(bq: int, bkv: int) -> int:
    """Dynamic shared memory of the cross-attention kernel: alignment slack,
    the Q ring, the K and V rings (rows of 128 bytes), and a full and an empty
    mbarrier per stage of each ring."""
    return (1024 + CROSS_Q_STAGES * bq * 64 * 2 + 2 * CROSS_KV_STAGES * bkv * 64 * 2
            + 8 * 2 * (CROSS_Q_STAGES + CROSS_KV_STAGES))


@dataclass(frozen=True)
class CrossPlan:
    """The schedule of one cross-attention call."""

    bq: int  # q rows per tile
    bkv: int  # keys of the one KV tile (past Skv: TMA's zeros, masked)
    q_tiles: int  # q tiles per (batch, head)
    tiles: int  # all tiles: B * H * q_tiles
    grid: int  # persistent blocks; block i walks tiles i, i + grid, ...
    smem_bytes: int
    heads: int

    def tile_at(self, t):
        """(batch, head, first q row) of tile ``t``: the head fastest, then
        the q tile, then the batch (``tile_at`` of ``flash_d64_kernel_cross``),
        so that consecutive tiles read the same q rows."""
        qt, bi = t // self.heads % self.q_tiles, t // self.heads // self.q_tiles
        return bi, t % self.heads, qt * self.bq

    def tiles_of(self, block: int) -> range:
        """The tiles block ``block`` walks, in order: strided by the grid, so
        that the blocks running together cover whole rows of q."""
        return range(block, self.tiles, self.grid)


@functools.lru_cache(maxsize=None)
def plan_cross(b: int, sq: int, skv: int, h: int, d: int, sms: int = H100_SMS) -> CrossPlan:
    """The cross-attention kernel's schedule, a pure function of the shape
    (and the SM count): the q tile as :func:`plan` picks it at D = 64 (128 or
    192 rows, 64 for each consumer warpgroup; a head's last tile may reach past
    Sq, a multiple of 64), the smallest KV tile that holds every key, one
    persistent block per SM at most, the tiles walked heads fastest and strided
    by the grid: a tile reads 128 bytes of each of its q rows, and the blocks
    running together read whole rows (at [8, 4096, 10, 64] 72.7% of 3.35 TB/s
    with L2 cold, against 58-60% for contiguous ranges of a head's tiles on an
    H100, ``tools/variants_flash_cross.py``)."""
    if d != 64:
        raise ValueError(f"cross-attention plan: no kernel for head dim {d}")
    if min(b, h) < 1 or sq < 128 or sq % SLICE or not 1 <= skv <= CROSS_KV_TILES[-1]:
        raise ValueError(f"cross-attention plan: q rows {sq} must be a multiple of {SLICE} "
                         f"and at least 128, keys {skv} 1 to {CROSS_KV_TILES[-1]}, batch {b} "
                         f"and heads {h} positive")
    bq = _q_tile(b, sq, h, d, sms)
    bkv = min(t for t in CROSS_KV_TILES if t >= skv)
    q_tiles = -(-sq // bq)
    tiles = b * h * q_tiles
    return CrossPlan(bq=bq, bkv=bkv, q_tiles=q_tiles, tiles=tiles, grid=min(tiles, sms),
                     smem_bytes=smem_bytes_cross(bq, bkv), heads=h)


def supports_cross(q_shape, kv_len: int, dtype: torch.dtype) -> bool:
    """The cross-attention kernel's gate: bf16, D = 64, every key in one KV
    tile and fewer than the flash gate's 128 (1 <= Skv < 128), Sq at least 128
    and a multiple of 64.  It takes the UNet's cross-attention at any batch and
    head count; the CLIP towers (Sq = 77), fp32 calls and the tiny model keep
    the plain version."""
    if len(q_shape) != 4 or dtype != torch.bfloat16:
        return False
    sq, d = q_shape[1], q_shape[3]
    return d == 64 and 1 <= kv_len < 128 and sq >= 128 and sq % SLICE == 0


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


def attention_cross_tiled_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None,
    unmasked: bool = False, round_first: bool = False,
) -> torch.Tensor:
    """The cross-attention kernel's schedule in plain PyTorch, for tests only:
    per block of :func:`plan_cross` its tiles, in order; per tile the scores
    against the one KV tile (K and V zero past Skv) in fp32, the padded keys
    set to -inf, the exact row max and sum of exp2(s scale log2(e) - max scale
    log2(e)), P times 1 / sum in fp32, rounded to v's dtype, P.V in fp32 and
    one rounding of O.  It differs from ``attention_plain`` only in the order
    of the sums and in where exp's argument rounds.  Two planted faults:
    ``unmasked`` leaves the padded keys in the softmax, ``round_first`` rounds
    P to bf16 before it is normalised (and divides O by the sum, as the flash
    kernel's online softmax does)."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    scale = scale if scale is not None else d**-0.5
    pl = plan_cross(b, sq, skv, h, d)
    c = torch.tensor(scale * 1.4426950408889634, dtype=torch.float32)
    kp = torch.zeros((b, pl.bkv, h, d), dtype=k.dtype, device=k.device)
    vp = torch.zeros((b, pl.bkv, h, d), dtype=v.dtype, device=v.device)
    kp[:, :skv], vp[:, :skv] = k, v
    out = torch.empty_like(q)
    for block in range(pl.grid):
        for t in pl.tiles_of(block):
            bi, hi, q0 = pl.tile_at(t)
            rows = min(pl.bq, sq - q0)  # a head's last tile may reach past Sq
            s = q[bi, q0:q0 + rows, hi].float() @ kp[bi, :, hi].float().T
            if not unmasked:
                s[:, skv:] = float("-inf")
            m = s.max(dim=1, keepdim=True).values
            p = torch.exp2(s * c - m * c)
            l = p.sum(dim=1, keepdim=True)
            if round_first:
                o = (p.to(v.dtype).float() @ vp[bi, :, hi].float()) / l
            else:
                o = (p * (1.0 / l)).to(v.dtype).float() @ vp[bi, :, hi].float()
            out[bi, q0:q0 + rows, hi] = o.to(q.dtype)
    return out


def attention_tiled_plain_f32(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None,
    kv_tiles_skipped: int = 0,
) -> torch.Tensor:
    """The fp32 kernel's schedule in plain PyTorch, for tests only: per tile
    of :func:`plan_f32`, per KV tile the scores in fp32 times the scale, the
    running max, the rescale of sum and output, P.V in fp32 over the keys in
    the plan's order (D = 64: the order of P's fragments, which the kernel's
    prologue writes V^T in); O / l at the end.  It differs from
    ``attention_plain`` only in the order of the sums.  ``kv_tiles_skipped``
    plants a fault: the walk stops that many KV tiles short."""
    b, sq, h, d = q.shape
    scale = scale if scale is not None else d**-0.5
    pl = plan_f32(b, sq, k.shape[1], h, d)
    order = torch.tensor([8 * g + i for g in range(pl.bkv // 8) for i in pl.key_order])
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for t in range(pl.tiles):
        bi, hi, q0 = pl.tile_at(t)
        qs = q[bi, q0:q0 + pl.bq, hi].float()
        m = torch.full((pl.bq, 1), -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros((pl.bq, 1), dtype=torch.float32, device=q.device)
        o = torch.zeros((pl.bq, d), dtype=torch.float32, device=q.device)
        for j in range(pl.kv_tiles - kv_tiles_skipped):
            kt = k[bi, j * pl.bkv:(j + 1) * pl.bkv, hi].float()
            vt = v[bi, j * pl.bkv:(j + 1) * pl.bkv, hi].float()
            s = (qs @ kt.T) * scale
            mx = torch.maximum(m, s.max(dim=1, keepdim=True).values)
            alpha, p = torch.exp(m - mx), torch.exp(s - mx)
            l = l * alpha + p.sum(dim=1, keepdim=True)
            o = o * alpha + p[:, order] @ vt[order]
            m = mx
        out[bi, q0:q0 + pl.bq, hi] = o / l
    return out


def _check_layout(q, k, v):
    check_dtypes("flash_attention", q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError("flash_attention: q, k and v must be on one device")
        if t.dim() != 4 or t.stride(3) != 1 or t.stride(2) != t.shape[3]:
            raise ValueError(
                f"flash_attention: {name} must be BSHD with contiguous heads"
            )
        if t.stride(1) % (16 // t.element_size()) or t.stride(0) % (16 // t.element_size()) \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} rows must be 16-byte aligned")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not match"
        )


def _check(q, k, v):
    _check_layout(q, k, v)
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
    check_dtypes("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    _check(q, k, v)
    from fastedit_tpu_torch.ops.build import library

    b, sq, h, _ = q.shape
    f32 = q.dtype == torch.float32
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, sq, k.shape[1], d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            float(scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if f32:  # raises on a shape the kernel does not take
            pl = plan_f32(b, sq, k.shape[1], h, d, sm_count_of(q))
            scratch = torch.empty(pl.scratch_floats, dtype=q.dtype, device=q.device)
            entry = getattr(library("flash_attention_tf32x3"), f"flash_attention_d{d}_tf32x3")
            err = entry(*args[:4], scratch.data_ptr(), *args[4:8], *args[9:], pl.grid, stream)
        else:
            pl = plan_for(q, k.shape[1])
            err = library("flash_attention").flash_attention_bf16(
                *args, pl.bq, pl.bkv, pl.grid, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    (launches_f32 if f32 else launches)[d] += 1
    return out


def cross_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """Cross-attention with every key in one KV tile, BSHD: q [B,Sq,H,64],
    k/v [B,Skv,H,64] bf16 -> [B,Sq,H,64] (:func:`supports_cross`).

    A CPU tensor takes the plain version; a CUDA tensor launches
    ``flash_d64_kernel_cross`` (once) or raises."""
    global cross_launches
    d = q.shape[-1]
    scale = scale if scale is not None else d**-0.5
    check_dtypes("cross_attention", q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    _check_layout(q, k, v)
    if not supports_cross(tuple(q.shape), k.shape[1], q.dtype):
        raise ValueError(f"the cross-attention kernel does not take {q.dtype} q "
                         f"{tuple(q.shape)}, kv length {k.shape[1]}")
    from fastedit_tpu_torch.ops.build import library

    b, sq, h, _ = q.shape
    skv = k.shape[1]
    pl = plan_cross(b, sq, skv, h, d, sm_count_of(q))
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = library("flash_attention").cross_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, sq, skv, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            float(scale), pl.bq, pl.bkv, pl.grid, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cross_attention kernel launch failed: CUDA error {err}")
    cross_launches += 1
    return out
