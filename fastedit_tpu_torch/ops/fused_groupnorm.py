"""GroupNorm (+ SiLU) over NHWC: CUDA kernel wrappers, their schedule and
their plain versions.

The kernels (``csrc/group_norm.cu``) replace the TPU kernel
``fastedit_tpu/ops/fused_groupnorm.py`` (``fused_group_norm`` ->
``_fused_gn_4d``), which carries its group sums across grid steps in VMEM
scratch over three passes of x.  On the card a call is two launches:

* the statistics launch: each block streams a chunk of whole pixels through
  a ring of shared-memory stages (x read once); each thread keeps the mean
  and centred M2 of its channels, two passes over its values of a stage on
  chip, merged stage by stage with Chan's formula; the block merges them per
  group into the chunk's (mean, M2), and the last block of each batch item to
  finish merges the chunks in a fixed order and writes scale = rstd * gamma
  and shift = beta - mean * scale per channel;
* the apply launch: y = x * scale + shift (+ SiLU), one rounding to x's
  dtype.

Where the tensor fits the SMs' shared memory (:func:`plan`'s resident route),
both are one cooperative launch: every block keeps its chunk on chip, waits
at a barrier of its batch item, merges the chunks itself and writes its
output from shared memory, so x is read once.

:func:`group_norm_scale_shift` is the statistics launch alone: the fp32
``(scale, shift)`` of the fused resnet conv's prologue, which the JAX
package computes in XLA (``fastedit_tpu/ops/groupnorm.py``
``group_norm_scale_shift``).  :func:`plan` is the schedule, a pure function
of the shape and the SM count; :func:`group_norm_chunked_plain` walks it in
plain PyTorch (chunk partials, then the merge in the kernel's order), for the
tests.  Both kernels are gated by ``flags.use_cuda_groupnorm``.

The kernels are templates over the element type: bf16, and fp32 for the
quality mode (the ``_f32`` C entries, with launch counters of their own).  A
thread owns 8 channels of a pixel either way (one 16-byte vector in bf16,
two in fp32), so the plan's thread layout is the same; it takes the item size
(:func:`plan`), since a stage of pixels holds twice the bytes in fp32: at most
4 vectors per thread and stage there, and the resident route's ring holds
half the pixels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from fastedit_tpu_torch.ops.conv3x3 import H100_SMS, check_dtypes, sm_count_of
from fastedit_tpu_torch.ops.groupnorm import group_norm_plain, group_norm_scale_shift_plain

# Launches since the last reset (chip_smoke.py resets them): GroupNorm calls
# (one or two kernels each) and statistics-only calls (one kernel each), bf16
# and fp32.
launches = 0
scale_shift_launches = 0
launches_f32 = 0
scale_shift_launches_f32 = 0

# The kernels' limits and shared memory (csrc/group_norm.cu holds the same).
MAX_THREADS = 512  # data threads of a block: lanes x C / 8
MAX_CHANNELS = 4096  # 512 16-byte vectors; the [lanes][C] (mean, M2) fill 32 KB
MAX_GROUPS = 128
MAX_STAGES = 4
RING_BYTES = 192 * 1024  # a statistics block's stages
STATIC_SMEM_BYTES = 2 * 4 * MAX_CHANNELS + 4 * MAX_THREADS + 8 * MAX_STAGES + 4
SMEM_LIMIT = 227 * 1024
VECS = {2: (8, 4, 2, 1), 4: (4, 2, 1)}  # item size -> vectors per thread in a stage
APPLY_BLOCKS_PER_SM = 4  # 512-thread apply blocks an SM holds at once
MERGE_LANES = 32  # a warp's lanes; a group's merge takes a run of them


@dataclass(frozen=True)
class GroupNormPlan:
    """The schedule of one GroupNorm call on [b, hw, c] with ``groups``."""

    b: int
    hw: int
    c: int
    groups: int
    lanes: int  # pixels a block covers side by side (one thread per 8 channels each)
    threads: int  # block size: lanes * c / 8 rounded up to warps
    vecs: int  # 16-byte vectors per thread in a stage
    tile_px: int  # pixels per stage: lanes * vecs
    ntiles: int  # stages per batch item
    tiles_per_chunk: int
    nchunk: int  # statistics blocks per batch item
    stages: int  # ring depth
    apply_px: int  # pixels per apply block
    napply: int  # apply blocks per batch item
    route: str  # "resident": one cooperative launch; "two_launch": statistics, then apply
    itemsize: int = 2  # x's: 2 (bf16) or 4 (fp32)

    @property
    def stage_bytes(self) -> int:
        return self.tile_px * self.c * self.itemsize

    @property
    def smem_bytes(self) -> int:
        """Shared memory of a statistics block: the ring and the partials."""
        return self.stages * self.stage_bytes + STATIC_SMEM_BYTES

    @property
    def grid(self) -> tuple[int, int]:
        return (self.nchunk, self.b)

    @property
    def apply_grid(self) -> tuple[int, int]:
        return (self.napply, self.b)

    @property
    def merge_lanes(self) -> int:
        """Lanes that merge one group's entries (the kernel's
        ``merge_lanes``): the fewest of 32, 16, ..., 1 with which the block's
        warps take all groups in one round."""
        sub = MERGE_LANES
        while sub > 1 and (self.threads // 32) * (MERGE_LANES // sub) < self.groups:
            sub //= 2
        return sub

    @property
    def chunk_px(self) -> int:
        return self.tiles_per_chunk * self.tile_px

    def chunks(self) -> list[tuple[int, int]]:
        """Pixel range [p0, p1) of each statistics block of a batch item."""
        return [(k * self.chunk_px, min((k + 1) * self.chunk_px, self.hw))
                for k in range(self.nchunk)]

    def apply_chunks(self) -> list[tuple[int, int]]:
        return [(k * self.apply_px, min((k + 1) * self.apply_px, self.hw))
                for k in range(self.napply)]


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def plan(b: int, hw: int, c: int, groups: int, sms: int = H100_SMS,
         itemsize: int = 2) -> GroupNormPlan:
    """The kernels' schedule, a pure function of the shape, the SM count and
    x's item size (2 for bf16, 4 for fp32).

    A block covers ``lanes`` pixels side by side, one thread per 8 channels
    (at most 512 threads).  A stage is ``vecs`` such rows of pixels: the
    largest of 8, 4, 2, 1 vectors per thread (4, 2, 1 in fp32: the same
    bytes) that still gives every SM a stage.  Chunks of whole stages, about
    one per SM over the batch (at most 4096 / G), each streamed through a
    ring of up to 4 stages in 192 KB.  The
    apply launch gives each of ``APPLY_BLOCKS_PER_SM`` blocks per SM one
    contiguous range (at least a row of ``lanes`` pixels).  Where the ring
    holds each chunk whole and the blocks fit the SMs one each, the route is
    resident: one cooperative launch that keeps x on chip across a barrier
    and writes the output from there (one read of x)."""
    if min(b, hw, c, groups) < 1 or not supports((b, 1, hw, c), groups):
        raise ValueError(f"group_norm kernel does not take [{b}, {hw}, {c}], G={groups}")
    if itemsize not in VECS:
        raise ValueError(f"group_norm plan: item size {itemsize}; the kernels take bf16 or fp32")
    vc = c // 8
    lanes = max(1, MAX_THREADS // vc)
    threads = _ceil(lanes * vc, 32) * 32
    for vecs in VECS[itemsize]:
        tile_px = lanes * vecs
        if b * _ceil(hw, tile_px) >= sms:
            break
    ntiles = _ceil(hw, tile_px)
    # the last block stages every chunk's (mean, M2): nchunk x G of them
    tiles_per_chunk = _ceil(ntiles, min(ntiles, _ceil(sms, b), MAX_CHANNELS // groups))
    nchunk = _ceil(ntiles, tiles_per_chunk)
    stages = min(MAX_STAGES, RING_BYTES // (tile_px * c * itemsize), tiles_per_chunk)
    napply = min(_ceil(hw, lanes), _ceil(APPLY_BLOCKS_PER_SM * sms, b))
    apply_px = _ceil(_ceil(hw, napply), lanes) * lanes
    napply = _ceil(hw, apply_px)
    # resident: every chunk held whole by its ring and every block on an SM at once
    route = "resident" if stages == tiles_per_chunk and b * nchunk <= sms else "two_launch"
    return GroupNormPlan(b, hw, c, groups, lanes, threads, vecs, tile_px, ntiles,
                         tiles_per_chunk, nchunk, stages, apply_px, napply, route, itemsize)


def plan_for(x: torch.Tensor, groups: int) -> GroupNormPlan:
    b, h, w, c = x.shape
    return plan(b, h * w, c, groups, sm_count_of(x), x.element_size())


def supports(shape, num_groups: int) -> bool:
    """NHWC 4-D, C % G == 0 and G <= 128 (the JAX package's conditions;
    its VMEM budget admits every main-path shape and does not carry over),
    and C % 8 == 0, C <= 4096 (16-byte vectors, one per thread per pixel)."""
    if len(shape) != 4:
        return False
    c = shape[-1]
    return (c % num_groups == 0 and num_groups <= MAX_GROUPS and c % 8 == 0
            and c <= MAX_CHANNELS)


# ------------------------------------------------------------ plain walk


def lane_merge(n, mean, m2, lanes: int):
    """The kernel's ``group_merge`` over the last dim by ``lanes`` lanes, in
    float64: the mean from the weighted sum of the entries' means, then M2 =
    sum of M2_k + n_k (mean_k - mean)^2; each sum as the lanes form it (lane
    i adds entries i, i + lanes, ... in turn, then a butterfly: lane i adds
    lane i ^ (lanes / 2)'s, ..., ^ 1's).  Returns (n, mean, M2) without the
    last dim."""
    *lead, m = mean.shape
    rounds = _ceil(m, lanes)
    n, mean, m2 = (F.pad(t.double().expand(*lead, m), (0, rounds * lanes - m))
                   .reshape(*lead, rounds, lanes) for t in (n, mean, m2))

    def warp_sum(v):
        s = torch.zeros((*lead, lanes), dtype=torch.float64)
        for r in range(rounds):
            s = s + v[..., r, :]
        off = lanes // 2
        while off:
            s = s + s[..., torch.arange(lanes) ^ off]
            off //= 2
        return s[..., 0]

    total = warp_sum(n)
    mu = warp_sum(n * mean) / total
    d = mean - mu[..., None, None]
    return total, mu, warp_sum(m2 + n * d * d)


def chunk_partials(x: torch.Tensor, p: GroupNormPlan):
    """Each statistics block's (mean, M2) per group, as the kernel forms
    them: per thread and channel, each stage's mean and centred M2 of its
    values, merged stage by stage into the thread's running ones with Chan's
    formula (fp32, one pair of weights per thread); then per group over the
    block's lanes x C / G entries (:func:`lane_merge`).  Pixel l + k * lanes
    of a stage is thread row l's k-th.  Returns (n [nchunk] float64, mean
    and M2 [b, nchunk, G] fp32, as the workspace holds them)."""
    b, c, g = p.b, p.c, p.groups
    padded = p.nchunk * p.chunk_px
    xf = F.pad(x.float().reshape(b, p.hw, c), (0, 0, 0, padded - p.hw))
    tiles = xf.reshape(b, p.nchunk, p.tiles_per_chunk, p.vecs, p.lanes, c)
    valid = (torch.arange(padded) < p.hw).reshape(p.nchunk, p.tiles_per_chunk, p.vecs, p.lanes)
    cnt = torch.zeros((1, p.nchunk, p.lanes, 1))
    mean = torch.zeros((b, p.nchunk, p.lanes, c))
    m2 = torch.zeros_like(mean)
    for j in range(p.tiles_per_chunk):
        v = valid[None, :, j, :, :, None]  # [1, nchunk, vecs, lanes, 1]
        nb = v.sum(2).float()  # [1, nchunk, lanes, 1]
        lm = (tiles[:, :, j] * v).sum(2) * (1.0 / torch.where(nb > 0, nb, torch.ones_like(nb)))
        lq = ((tiles[:, :, j] - lm[:, :, None]) * v).square().sum(2)
        # Chan's merge, one pair of weights per thread (none where nb == 0)
        tot = cnt + nb
        inv_tot = 1.0 / torch.where(tot > 0, tot, torch.ones_like(tot))
        delta = lm - mean
        mean = mean + delta * (nb * inv_tot)
        m2 = m2 + (lq + delta * delta * (cnt * nb * inv_tot))
        cnt = tot
    cg = c // g

    def by_group(t):  # [., nchunk, lanes, C] -> [., nchunk, G, lanes x cg], lane-row major
        t = t.expand(-1, -1, -1, c).reshape(t.shape[0], p.nchunk, p.lanes, g, cg)
        return t.transpose(2, 3).reshape(t.shape[0], p.nchunk, g, p.lanes * cg)

    _, cmean, cm2 = lane_merge(by_group(cnt), by_group(mean), by_group(m2), p.merge_lanes)
    counts = torch.tensor([(p1 - p0) * cg for p0, p1 in p.chunks()], dtype=torch.float64)
    return counts, cmean.float(), cm2.float()


def merge_chunks(counts: torch.Tensor, mean: torch.Tensor, m2: torch.Tensor, lanes: int):
    """The last block's merge of the chunk partials by ``lanes`` lanes per
    group (:func:`lane_merge` over the chunks, in float64).  Returns (mean,
    var) [b, G] float64."""
    n, mu, q = lane_merge(counts, mean.transpose(1, 2), m2.transpose(1, 2), lanes)
    return mu, q / n


def scale_shift_chunked_plain(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5,
                              sms: int = H100_SMS):
    """fp32 (scale, shift) [B, C] from the statistics launch's schedule for
    x's dtype, walked in plain PyTorch (:func:`chunk_partials`,
    :func:`merge_chunks`)."""
    b, h, w, c = x.shape
    p = plan(b, h * w, c, num_groups, sms, x.element_size())
    mean, var = merge_chunks(*chunk_partials(x, p), p.merge_lanes)
    rstd = (1.0 / torch.sqrt(var + eps)).float()
    cg = c // num_groups
    scale = rstd.repeat_interleave(cg, dim=1) * gamma.float()[None, :]
    shift = beta.float()[None, :] - mean.float().repeat_interleave(cg, dim=1) * scale
    return scale, shift


def group_norm_chunked_plain(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5,
                             act: Optional[str] = None, sms: int = H100_SMS) -> torch.Tensor:
    """The two launches' arithmetic in plain PyTorch, on the schedule
    :func:`plan` gives for ``sms`` SMs: y = x * scale + shift (+ SiLU), in
    x's dtype."""
    if act not in (None, "silu"):
        raise ValueError(f"unsupported activation {act!r}")
    scale, shift = scale_shift_chunked_plain(x, gamma, beta, num_groups, eps, sms)
    y = x.float() * scale[:, None, None, :] + shift[:, None, None, :]
    return (F.silu(y) if act == "silu" else y).to(x.dtype)


# ------------------------------------------------------------- wrappers

_counters: dict[int, torch.Tensor] = {}


def _counter(x: torch.Tensor, b: int) -> torch.Tensor:
    """At least ``b`` uint32, zero between calls: the kernels set the ones
    they count on back to 0.  One buffer per device, for calls on one stream
    at a time."""
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    buf = _counters.get(index)
    if buf is None or buf.numel() < b:
        buf = _counters[index] = torch.zeros(max(b, 64), dtype=torch.int32, device=x.device)
    return buf


def _check(x, gamma, beta, num_groups):
    check_dtypes("group_norm", x)
    if not supports(tuple(x.shape), num_groups):
        raise ValueError(f"group_norm kernel does not take {tuple(x.shape)}, G={num_groups}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("group_norm: x must be a contiguous, 16-byte aligned NHWC tensor")
    c = x.shape[-1]
    gamma, beta = gamma.float().contiguous(), beta.float().contiguous()
    if gamma.shape != (c,) or beta.shape != (c,) or gamma.device != x.device \
            or beta.device != x.device:
        raise ValueError(f"group_norm: gamma and beta must be [{c}] on {x.device}")
    return gamma, beta


def _plan_args(p: GroupNormPlan) -> tuple:
    return (p.b, p.hw, p.c, p.groups, p.lanes, p.tile_px, p.tiles_per_chunk, p.nchunk,
            p.stages)


def _launch(name, x, *args):
    """C entry ``name`` for x's dtype (``<name>_bf16`` or ``<name>_f32``)."""
    from fastedit_tpu_torch.ops.build import library

    name += "_f32" if x.dtype == torch.float32 else "_bf16"
    fn = getattr(library("group_norm"), name)
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def fused_group_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
    act: Optional[str] = None,
) -> torch.Tensor:
    """x [B, H, W, C] bf16 or fp32, gamma/beta [C] -> GroupNorm(x) (+ SiLU)
    in x's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernels (one or two, by the plan's route) or raises."""
    check_dtypes("group_norm", x)
    if x.device.type == "cpu":
        return group_norm_plain(x, gamma, beta, num_groups, eps, act)
    if act not in (None, "silu"):
        raise ValueError(f"unsupported activation {act!r}")
    gamma, beta = _check(x, gamma, beta, num_groups)
    p = plan_for(x, num_groups)
    part = torch.empty((p.b, p.nchunk, num_groups, 2), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    counter = _counter(x, 2 * p.b).data_ptr()
    if p.route == "resident":
        _launch("group_norm_resident", x, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                out.data_ptr(), part.data_ptr(), counter, *_plan_args(p), float(eps),
                int(act == "silu"))
    else:
        scale_shift = torch.empty((2, p.b, p.c), dtype=torch.float32, device=x.device)
        _launch("group_norm", x, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                out.data_ptr(), scale_shift.data_ptr(), part.data_ptr(), counter,
                *_plan_args(p), p.apply_px, p.napply, float(eps), int(act == "silu"))
    global launches, launches_f32
    if x.dtype == torch.float32:
        launches_f32 += 1
    else:
        launches += 1
    return out


def group_norm_scale_shift(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``(scale, shift)`` [B, C] with GN(x) == x * scale + shift, from
    the statistics launch alone (one read of x).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    check_dtypes("group_norm_scale_shift", x)
    if x.device.type == "cpu":
        return group_norm_scale_shift_plain(x, gamma, beta, num_groups, eps)
    gamma, beta = _check(x, gamma, beta, num_groups)
    p = plan_for(x, num_groups)
    scale_shift = torch.empty((2, p.b, p.c), dtype=torch.float32, device=x.device)
    part = torch.empty((p.b, p.nchunk, num_groups, 2), dtype=torch.float32, device=x.device)
    _launch("group_norm_stats", x, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            scale_shift.data_ptr(), part.data_ptr(), _counter(x, p.b).data_ptr(),
            *_plan_args(p), float(eps))
    global scale_shift_launches, scale_shift_launches_f32
    if x.dtype == torch.float32:
        scale_shift_launches_f32 += 1
    else:
        scale_shift_launches += 1
    return scale_shift[0], scale_shift[1]
