"""GroupNorm (+ SiLU) over NHWC: the CUDA kernel's wrappers, its schedule and
their plain versions.

The kernel (``csrc/group_norm.cu``) replaces the TPU kernel
``fastedit_tpu/ops/fused_groupnorm.py`` (``fused_group_norm`` ->
``_fused_gn_4d``), which carries its group sums across grid steps in VMEM
scratch over three passes of x.  On the card a call is one launch, every
block of its grid resident at once:

* each block streams a chunk of whole pixels through a ring of shared-memory
  stages; each thread keeps the mean and centred M2 of its channels, two
  passes over its values of a stage on chip, merged stage by stage with
  Chan's formula; the block merges them per group into the chunk's (mean,
  M2);
* the blocks of a batch item form thread-block clusters; block 0 of each
  cluster merges its cluster's chunks out of their shared memory
  (distributed shared memory), writes one partial, meets the item's other
  clusters at a barrier, merges their partials in a fixed order and hands
  (mean, rstd) back to its cluster;
* each block writes y = x * scale + shift (+ SiLU), one rounding to x's
  dtype, tile by tile in the reverse order of loading: the tiles still in
  its ring first, then the rest loaded again, the latest first (the
  likeliest to be in L2).  Where the ring holds the chunk whole, x is read
  once (:func:`plan`'s ``"resident"`` route); otherwise the part that did not
  fit is read twice (``"reread"``).

:func:`group_norm_scale_shift` is the statistics alone (the same launch
without the barrier: the last cluster of each batch item to finish merges
and writes the fp32 ``(scale, shift)``), for the fused resnet conv's
prologue, which the JAX package computes in XLA (``fastedit_tpu/ops/
groupnorm.py`` ``group_norm_scale_shift``).  :func:`plan` is the schedule, a
pure function of the shape, the blocks the card holds at once, the item size
and the cluster size; :func:`group_norm_chunked_plain` walks it in plain
PyTorch (chunk partials, then the cluster's merge, then the batch item's, in
the kernel's order), for the tests.  Both entries are gated by
``flags.use_cuda_groupnorm``.

The kernel is a template over the element type: bf16, and fp32 for the
quality mode (the ``_f32`` C entries, with launch counters of their own).  A
thread owns 8 channels of a pixel either way (one 16-byte vector in bf16,
two in fp32), so the plan's thread layout is the same; it takes the item size
(:func:`plan`), since a stage of pixels holds twice the bytes in fp32: at most
4 vectors per thread and stage there, and the ring holds half the pixels.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from fastedit_tpu_torch.ops.conv3x3 import H100_SMS, check_dtypes
from fastedit_tpu_torch.ops.groupnorm import group_norm_plain, group_norm_scale_shift_plain

# Launches since the last reset (chip_smoke.py resets them): GroupNorm calls
# and statistics-only calls, bf16 and fp32; one kernel each.
launches = 0
scale_shift_launches = 0
launches_f32 = 0
scale_shift_launches_f32 = 0

# The kernel's limits and shared memory (csrc/group_norm.cu holds the same).
MAX_THREADS = 512  # data threads of a block: lanes x C / 8
MAX_CHANNELS = 4096  # 512 16-byte vectors; the [lanes][C] (mean, M2) fill 32 KB
MAX_GROUPS = 128
MAX_STAGES = 8
RING_BYTES = 192 * 1024  # a block's stages
MAX_CLUSTER = 16
MAX_PARTIALS = 128  # clusters per batch item
CLUSTER = 8  # blocks per cluster: the portable most
STATIC_SMEM_BYTES = (2 * 4 * MAX_CHANNELS + 8 * MAX_GROUPS + 8 * MAX_STAGES + 4 * MAX_STAGES + 4
                     + 4 * MAX_PARTIALS)
SMEM_LIMIT = 227 * 1024
VECS = {2: (8, 4, 2, 1), 4: (4, 2, 1)}  # item size -> vectors per thread in a stage
# Fixed costs in the plan's reckoning, as bytes a block would stream in the
# same time: a stage's (a wait, a barrier, a copy asked for) and a cluster
# partial's in the batch item's merge.
STAGE_COST_BYTES = 4 * 1024
PARTIAL_COST_BYTES = 512
# and a cluster launch's (scheduled by GPC) and its merge step's, once
CLUSTER_COST_BYTES = 48 * 1024
# The other cluster limit plan_for weighs: clusters of 2, which the H100 holds
# on all 132 SMs (120 in clusters of 4 or 8).
WIDE_CLUSTER = 2
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
    vecs: int  # 16-byte vectors (bf16; 32-byte in fp32) per thread in a stage
    tile_px: int  # pixels per stage: lanes * vecs
    ntiles: int  # stages per batch item
    nchunk: int  # blocks per batch item
    stages: int  # ring depth: the tiles a block keeps on chip
    cluster: int  # blocks per cluster; nchunk is a multiple of it
    route: str  # "resident": every chunk held whole; "reread": the rest read again
    itemsize: int = 2  # x's: 2 (bf16) or 4 (fp32)

    @property
    def stage_bytes(self) -> int:
        return self.tile_px * self.c * self.itemsize

    @property
    def smem_bytes(self) -> int:
        """Shared memory of a block: the ring and the partials."""
        return self.stages * self.stage_bytes + STATIC_SMEM_BYTES

    @property
    def grid(self) -> tuple[int, int]:
        return (self.nchunk, self.b)

    @property
    def nclusters(self) -> int:
        """Clusters per batch item: the partials its barrier merges."""
        return self.nchunk // self.cluster

    @property
    def merge_lanes(self) -> int:
        """Lanes that merge one group's entries (the kernel's
        ``merge_lanes``): the fewest of 32, 16, ..., 1 with which the block's
        warps take all groups in one round."""
        sub = MERGE_LANES
        while sub > 1 and (self.threads // 32) * (MERGE_LANES // sub) < self.groups:
            sub //= 2
        return sub

    def chunk_tiles(self, k: int) -> tuple[int, int]:
        """Tiles [t0, t1) of chunk k (the kernel's ``chunk_tile``)."""
        return (k * self.ntiles // self.nchunk, (k + 1) * self.ntiles // self.nchunk)

    @property
    def max_tiles(self) -> int:
        """The most tiles a chunk holds."""
        return -(-self.ntiles // self.nchunk)

    def chunks(self) -> list[tuple[int, int]]:
        """Pixel range [p0, p1) of each block of a batch item."""
        return [(t0 * self.tile_px, min(t1 * self.tile_px, self.hw))
                for t0, t1 in map(self.chunk_tiles, range(self.nchunk))]

    @property
    def reread_bytes(self) -> int:
        """Bytes of x read a second time over the call: each chunk's tiles
        beyond its ring (the image's last tile counted whole).  Of the
        chunks, ntiles % nchunk hold one tile more than the others."""
        q, r = divmod(self.ntiles, self.nchunk)
        extra = r * max(0, q + 1 - self.stages) + (self.nchunk - r) * max(0, q - self.stages)
        return self.b * extra * self.stage_bytes


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)  # a pure function, asked again at every call
def plan(b: int, hw: int, c: int, groups: int, sms: int = H100_SMS, itemsize: int = 2,
         cluster: int = CLUSTER) -> GroupNormPlan:
    """The kernel's schedule, a pure function of the shape, ``sms`` (the
    blocks the card holds at once in clusters of ``cluster``: the SM count,
    or fewer where the clusters do not tile the card's GPCs), x's item size (2
    for bf16, 4 for fp32) and the cluster size.

    A block covers ``lanes`` pixels side by side, one thread per 8 channels
    (at most 512 threads).  A stage is ``vecs`` such rows of pixels (8, 4, 2
    or 1 vectors per thread; 4, 2, 1 in fp32: the same bytes).  Each batch
    item gets up to ``sms // b`` blocks, at most one per stage, in whole
    clusters of up to ``cluster`` blocks (at most 128 and 4096 / G clusters,
    the partials the barrier stages), so every block of the grid is resident at
    once; chunk k holds stages [k ntiles / nchunk, (k + 1) ntiles / nchunk).
    The ring holds up to 8 stages in 192 KB.  Of the stage and cluster
    sizes, the pair of least :func:`cost`: the bytes the busiest block reads
    and a block's share of those read again, ``STAGE_COST_BYTES`` a stage,
    ``PARTIAL_COST_BYTES`` a cluster of its batch item and
    ``CLUSTER_COST_BYTES`` for clusters of more than one block; then the most
    blocks, the largest stage, the largest cluster.  The route is
    ``"resident"`` where every chunk fits its ring, else ``"reread"``."""
    if min(b, hw, c, groups) < 1 or not supports((b, 1, hw, c), groups):
        raise ValueError(f"group_norm kernel does not take [{b}, {hw}, {c}], G={groups}")
    if itemsize not in VECS:
        raise ValueError(f"group_norm plan: item size {itemsize}; the kernels take bf16 or fp32")
    if cluster not in (1, 2, 4, 8, 16):
        raise ValueError(f"group_norm plan: cluster {cluster}; 1, 2, 4, 8 or 16 blocks")
    if sms < b:
        raise ValueError(f"group_norm plan: {b} batch items on {sms} resident blocks")
    vc = c // 8
    lanes = max(1, MAX_THREADS // vc)
    threads = _ceil(lanes * vc, 32) * 32
    best = None
    for vecs in VECS[itemsize]:
        tile_px = lanes * vecs
        ntiles = _ceil(hw, tile_px)
        n = min(sms // b, ntiles)
        for k in (k for k in (16, 8, 4, 2, 1) if k <= min(cluster, n)):
            nchunk = k * min(n // k, MAX_CHANNELS // groups, MAX_PARTIALS)
            most = _ceil(ntiles, nchunk)
            stages = min(MAX_STAGES, RING_BYTES // (tile_px * c * itemsize), most)
            p = GroupNormPlan(b, hw, c, groups, lanes, threads, vecs, tile_px, ntiles, nchunk,
                              stages, k, "resident" if most <= stages else "reread", itemsize)
            score = (cost(p), -nchunk, -vecs, -k)
            if best is None or score < best[0]:
                best = (score, p)
    return best[1]


_slots: dict[tuple[int, int], int] = {}


def slots_of(x: torch.Tensor, cluster: int = CLUSTER) -> int:
    """Blocks x's card holds at once in clusters of ``cluster`` (the kernel's
    ``group_norm_slots``: ``cudaOccupancyMaxActiveClusters`` x cluster, for
    every instance of the kernel), once per device."""
    from fastedit_tpu_torch.ops.build import library

    lib = library("group_norm")  # built at first use (raises without nvcc)
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    if (index, cluster) not in _slots:
        out = ctypes.c_int(0)
        with torch.cuda.device(x.device):
            err = lib.group_norm_slots(cluster, ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"group_norm_slots({cluster}) failed: CUDA error {err}")
        _slots[(index, cluster)] = out.value
    return _slots[(index, cluster)]


def cost(p: GroupNormPlan) -> int:
    """What :func:`plan` weighs, in bytes: the busiest block's chunk, a
    block's share of the tiles read again (the blocks take them from one
    counter), and the fixed costs (the busiest block's stages, its batch
    item's partials, a cluster launch)."""
    most = p.max_tiles
    return (most * (p.stage_bytes + STAGE_COST_BYTES) + p.reread_bytes // (p.b * p.nchunk)
            + p.nclusters * PARTIAL_COST_BYTES + (p.cluster > 1) * CLUSTER_COST_BYTES)


def plan_for(x: torch.Tensor, groups: int) -> GroupNormPlan:
    """The plan for x on its card: of clusters up to ``CLUSTER`` over the
    blocks the card holds in them, and up to ``WIDE_CLUSTER`` over the more
    blocks it holds in those, the one that costs less."""
    b, h, w, c = x.shape
    return min((plan(b, h * w, c, groups, slots_of(x, k), x.element_size(), k)
                for k in dict.fromkeys((CLUSTER, WIDE_CLUSTER))), key=cost)


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
    """Each block's (mean, M2) per group, as the kernel forms them: per
    thread and channel, each stage's mean and centred M2 of its values,
    merged stage by stage into the thread's running ones with Chan's formula
    (fp32, one pair of weights per thread); then per group over the block's
    lanes x C / G entries (:func:`lane_merge`).  Pixel l + k * lanes of a
    stage is thread row l's k-th; a chunk shorter than the longest is padded
    with empty stages (which the kernel does not have, and which change no
    statistic).  Returns (n [nchunk] float64, mean and M2 [b, nchunk, G]
    fp32, as the kernel's shared memory holds them)."""
    b, c, g = p.b, p.c, p.groups
    padded = (p.ntiles + 1) * p.tile_px  # and one empty tile, the padding's
    xf = F.pad(x.float().reshape(b, p.hw, c), (0, 0, 0, padded - p.hw))
    tiles = xf.reshape(b, p.ntiles + 1, p.vecs, p.lanes, c)
    valid = (torch.arange(padded) < p.hw).reshape(p.ntiles + 1, p.vecs, p.lanes)
    index = torch.full((p.nchunk, p.max_tiles), p.ntiles)
    for k in range(p.nchunk):
        t0, t1 = p.chunk_tiles(k)
        index[k, :t1 - t0] = torch.arange(t0, t1)
    cnt = torch.zeros((1, p.nchunk, p.lanes, 1))
    mean = torch.zeros((b, p.nchunk, p.lanes, c))
    m2 = torch.zeros_like(mean)
    for j in range(p.max_tiles):
        xt = tiles[:, index[:, j]]  # [b, nchunk, vecs, lanes, c]
        v = valid[index[:, j]][None, :, :, :, None]  # [1, nchunk, vecs, lanes, 1]
        nb = v.sum(2).float()  # [1, nchunk, lanes, 1]
        lm = (xt * v).sum(2) * (1.0 / torch.where(nb > 0, nb, torch.ones_like(nb)))
        lq = ((xt - lm[:, :, None]) * v).square().sum(2)
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


def cluster_partials(counts: torch.Tensor, mean: torch.Tensor, m2: torch.Tensor,
                     p: GroupNormPlan):
    """Block 0's merge of its cluster's chunk partials, in rank order, by
    ``merge_lanes`` lanes per group (:func:`lane_merge`, float64), each
    rounded to fp32 as it goes to device memory.  Returns (n [clusters]
    float64, mean and M2 [b, clusters, G] fp32)."""
    ncl, k = p.nclusters, p.cluster

    def by_cluster(t):  # [b, nchunk, G] -> [b, clusters, G, k]
        return t.reshape(t.shape[0], ncl, k, -1).transpose(2, 3)

    n = counts.reshape(ncl, k)
    _, cmean, cm2 = lane_merge(n[None, :, None, :], by_cluster(mean), by_cluster(m2),
                               p.merge_lanes)
    return n.sum(1), cmean.float(), cm2.float()


def merge_chunks(counts: torch.Tensor, mean: torch.Tensor, m2: torch.Tensor, lanes: int):
    """The batch item's merge of its partials (the clusters') by ``lanes``
    lanes per group (:func:`lane_merge` over the partials, in float64).
    Returns (mean, var) [b, G] float64."""
    n, mu, q = lane_merge(counts, mean.transpose(1, 2), m2.transpose(1, 2), lanes)
    return mu, q / n


def scale_shift_chunked_plain(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5,
                              sms: int = H100_SMS, cluster: int = CLUSTER):
    """fp32 (scale, shift) [B, C] from the kernel's schedule for x's dtype,
    walked in plain PyTorch (:func:`chunk_partials`, :func:`cluster_partials`,
    :func:`merge_chunks`)."""
    b, h, w, c = x.shape
    p = plan(b, h * w, c, num_groups, sms, x.element_size(), cluster)
    mean, var = merge_chunks(*cluster_partials(*chunk_partials(x, p), p), p.merge_lanes)
    rstd = (1.0 / torch.sqrt(var + eps)).float()
    cg = c // num_groups
    scale = rstd.repeat_interleave(cg, dim=1) * gamma.float()[None, :]
    shift = beta.float()[None, :] - mean.float().repeat_interleave(cg, dim=1) * scale
    return scale, shift


def group_norm_chunked_plain(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5,
                             act: Optional[str] = None, sms: int = H100_SMS,
                             cluster: int = CLUSTER) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, on the schedule :func:`plan`
    gives for ``sms`` resident blocks and clusters of ``cluster``: y = x *
    scale + shift (+ SiLU), in x's dtype."""
    if act not in (None, "silu"):
        raise ValueError(f"unsupported activation {act!r}")
    scale, shift = scale_shift_chunked_plain(x, gamma, beta, num_groups, eps, sms, cluster)
    y = x.float() * scale[:, None, None, :] + shift[:, None, None, :]
    return (F.silu(y) if act == "silu" else y).to(x.dtype)


# ------------------------------------------------------------- wrappers

_counters: dict[int, torch.Tensor] = {}


def _counter(x: torch.Tensor, b: int) -> torch.Tensor:
    """At least ``b`` uint32, zero between calls: the kernel sets the ones
    it counts on back to 0.  One buffer per device, for calls on one stream
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
    return (p.b, p.hw, p.c, p.groups, p.lanes, p.tile_px, p.ntiles, p.nchunk, p.stages,
            p.cluster)


def _launch(name, x, *args):
    """C entry ``name`` for x's dtype (``<name>_bf16`` or ``<name>_f32``)."""
    from fastedit_tpu_torch.ops.build import library

    name += "_f32" if x.dtype == torch.float32 else "_bf16"
    fn = getattr(library("group_norm"), name)
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _batches(x: torch.Tensor) -> list:
    """x's batch in runs of at most the card's resident blocks (one block per
    batch item at least): each run is a launch of its own."""
    step = slots_of(x, CLUSTER)
    return [x[i:i + step] for i in range(0, x.shape[0], step)]


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

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (once; once per run of batch items past the card's resident blocks) or
    raises."""
    check_dtypes("group_norm", x)
    if x.device.type == "cpu":
        return group_norm_plain(x, gamma, beta, num_groups, eps, act)
    if act not in (None, "silu"):
        raise ValueError(f"unsupported activation {act!r}")
    gamma, beta = _check(x, gamma, beta, num_groups)
    out = torch.empty_like(x)
    global launches, launches_f32
    for xs, os in zip(_batches(x), _batches(out)):
        p = plan_for(xs, num_groups)
        part = torch.empty((p.b, p.nclusters, num_groups, 2), dtype=torch.float32,
                           device=x.device)
        _launch("group_norm", xs, xs.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                os.data_ptr(), part.data_ptr(), _counter(x, 4 * p.b).data_ptr(),
                *_plan_args(p), float(eps), int(act == "silu"))
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
    the statistics alone (one read of x).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    check_dtypes("group_norm_scale_shift", x)
    if x.device.type == "cpu":
        return group_norm_scale_shift_plain(x, gamma, beta, num_groups, eps)
    gamma, beta = _check(x, gamma, beta, num_groups)
    scale_shift = torch.empty((2, x.shape[0], x.shape[-1]), dtype=torch.float32,
                              device=x.device)
    global scale_shift_launches, scale_shift_launches_f32
    first = 0
    for xs in _batches(x):
        p = plan_for(xs, num_groups)
        ss = scale_shift[:, first:first + p.b]
        ss = ss if p.b == x.shape[0] else torch.empty_like(ss)
        part = torch.empty((p.b, p.nclusters, num_groups, 2), dtype=torch.float32,
                           device=x.device)
        _launch("group_norm_stats", xs, xs.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                ss.data_ptr(), part.data_ptr(), _counter(x, p.b).data_ptr(),
                *_plan_args(p), float(eps))
        if p.b != x.shape[0]:
            scale_shift[:, first:first + p.b] = ss
        first += p.b
        if x.dtype == torch.float32:
            scale_shift_launches_f32 += 1
        else:
            scale_shift_launches += 1
    return scale_shift[0], scale_shift[1]
