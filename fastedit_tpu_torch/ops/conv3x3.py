"""3x3 SAME stride-1 conv, NHWC: CUDA kernel wrapper and its plain version.

The kernel (``csrc/conv3x3.cu``) replaces the TPU kernel
``fastedit_tpu/ops/conv3x3.py`` (``conv3x3`` -> ``_conv3x3_call``): an
implicit GEMM over the 9 taps on the tensor cores (``wgmma``), fp32
accumulation, and an fp32 epilogue (bias, then optional SiLU, then one
rounding to bf16).  Its schedule is decided here, by :func:`plan`: an output
tile is a rectangle of 8 x 16 pixels of one image times ``bn`` output
channels, its 10 x 18 halo is staged once per 64 input channels and all nine
taps are read from it.  :func:`conv3x3_tiled_plain` walks the same schedule
in plain PyTorch, for the tests.  :func:`plan_down2` is the schedule of the
stride-2 form of the same kernel (``ops/conv_fused.conv3x3_down2``), whose
tiles stage windows of the input's four parity planes instead of one halo, and
:func:`plan_up2` that of the upsample form (``ops/conv_fused.conv3x3_up2``),
whose tiles are rectangles of the low-res input times one of four phases.

fp32 (the quality mode): a CUDA fp32 tensor launches the kernel's fp32
instance, on the tensor cores in 3xTF32 (``csrc/conv3x3_tf32x3.cu``
``conv3x3_tf32x3_kernel``: every product as three TF32 products, the
activations split in registers and the weights once per weight version into
TF32 hi and lo copies, ``ops/conv_fused.split_tf32``, which the call takes as
``w_split``): :func:`plan` at item size 4 is its schedule (the same
rectangles over chunks of 32 channels, channel tiles of 80, 64, 48 or 8) and
:func:`conv3x3_tiled_plain_f32` walks it in plain PyTorch, for the tests.  The
fp32 fused, upsample and stride-2 convs are the same kernel's other forms, on
:func:`plan` (``fused=True``: its ready barriers), :func:`plan_up2` and
:func:`plan_down2` at item size 4.  Each dtype's kernel has its own launch
counter.

Layouts: ``x`` is NHWC ``[B, H, W, Cin]``; ``weight`` is PyTorch's OIHW
``[Cout, Cin, 3, 3]`` and the kernel reads it in channels_last memory
(OHWI), so both GEMM operands are contiguous along Cin.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

# Launches of the CUDA kernel since the last reset (chip_smoke.py resets it),
# bf16 and fp32.
launches = 0
launches_f32 = 0


# The stride-1 kernel's geometry (csrc/conv3x3.cu holds the same constants).
RECT_H, RECT_W = 8, 16  # output pixels per tile
CHUNK = 64  # input channels per staged halo: 128 bytes, one swizzle row
HALO_STAGES, WEIGHT_STAGES = 3, 6
BN_INSTANCES = (8, 128, 160)  # channel tiles the kernel is instantiated for
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on an H100
H100_SMS = 132


# Its fp32 instance (csrc/conv3x3_tf32x3.cu, 3xTF32 on wgmma, one core for
# every form): chunks of 32 channels, so a pixel's chunk is 128 bytes as in
# bf16; a halo stage is 23 KB, three of them; a weight stage is one tap's hi and
# lo copies, as many stages as fit beside the halos, at most eight.  The fused
# and the upsample forms take the same rings and channel tiles.
F32_CHUNK = 32
CONV_F32_HALO_STAGES, CONV_F32_MAX_WEIGHT_STAGES = 3, 8
CONV_F32_BN = (8, 48, 64, 80)  # channel tiles the fp32 instance is built for


@dataclass(frozen=True)
class ConvPlan:
    """The schedule of one stride-1 conv call (plain or fused; bf16, or fp32
    on the 3xTF32 instance)."""

    rect: tuple[int, int]  # output rectangle (rows, columns) of one tile
    bn: int  # output channels per tile: the wgmma N
    tiles_y: int  # rectangles per image column
    tiles_x: int  # rectangles per image row
    tiles_n: int  # channel tiles
    tiles: int  # all tiles: B * tiles_y * tiles_x * tiles_n
    grid: int  # persistent blocks; block i walks tiles i, i + grid, ...
    smem_bytes: int  # dynamic shared memory of the instance
    box_x: tuple[int, int, int, int]  # TMA box over x [Cin, W, H, B], innermost first
    box_w: tuple[int, int, int]  # TMA box over the weight [Cin, 9, Cout]
    chunk: int = CHUNK  # input channels a halo stage holds: 64 (bf16) or 32 (fp32)
    halo_stages: int = HALO_STAGES
    weight_stages: int = WEIGHT_STAGES

    def rectangles(self, h: int, w: int):
        """(y0, x0) of every rectangle of one image, in the kernel's order."""
        return [(ty * self.rect[0], tx * self.rect[1])
                for ty in range(self.tiles_y) for tx in range(self.tiles_x)]

    def prologue_exps(self, b: int, h: int, w: int, cin: int) -> int:
        """exp evaluations of the fused prologue: one per staged in-image
        element, for every channel tile that stages it."""
        rows = sum(min(h, y0 + self.rect[0] + 1) - max(0, y0 - 1)
                   for y0 in range(0, h, self.rect[0]))
        cols = sum(min(w, x0 + self.rect[1] + 1) - max(0, x0 - 1)
                   for x0 in range(0, w, self.rect[1]))
        return b * rows * cols * cin * self.tiles_n


def tile_at(pl: ConvPlan, t):
    """(image, y0, x0, first channel) of tile ``t`` of the kernel's walk:
    channel tile fastest, then the rectangle's column, its row, the image
    (``tile_at`` in csrc/conv3x3.cu).  ``t`` may be an integer array."""
    m, n = t // pl.tiles_n, t % pl.tiles_n
    row, tx = m // pl.tiles_x, m % pl.tiles_x
    return row // pl.tiles_y, (row % pl.tiles_y) * pl.rect[0], tx * pl.rect[1], n * pl.bn


def smem_bytes(bn: int) -> int:
    """Dynamic shared memory of the instance with channel tile ``bn``: 1024
    bytes of alignment slack, the halo ring (stages rounded up to 1024
    bytes), the weight ring and the mbarriers."""
    halo = (RECT_H + 2) * (RECT_W + 2) * CHUNK * 2
    halo_stage = -(-halo // 1024) * 1024
    return (1024 + HALO_STAGES * halo_stage + WEIGHT_STAGES * bn * CHUNK * 2
            + 8 * (3 * HALO_STAGES + 2 * WEIGHT_STAGES))


def _halo_stage_f32() -> int:
    """Bytes of an fp32 halo stage: (8 + 2) x (16 + 2) pixels of 128 bytes,
    rounded up to 1024."""
    return -(-((RECT_H + 2) * (RECT_W + 2) * F32_CHUNK * 4) // 1024) * 1024


def _bars_f32(sb: int, fused: bool) -> int:
    """mbarrier bytes of the fp32 stride-1 instance: a full and an empty one
    per stage, and per halo stage a ready one for the fused form."""
    return 8 * ((3 if fused else 2) * CONV_F32_HALO_STAGES + 2 * sb)


def conv_f32_weight_stages(bn: int, fused: bool = False) -> int:
    """Weight stages of the fp32 stride-1 instance (one tap's hi and lo
    copies, 2 x bn x 128 bytes, each): as many as fit beside three halo
    stages, at most eight."""
    room = (SMEM_LIMIT - 1024 - CONV_F32_HALO_STAGES * _halo_stage_f32()
            - _bars_f32(CONV_F32_MAX_WEIGHT_STAGES, fused))
    return min(CONV_F32_MAX_WEIGHT_STAGES, room // (2 * bn * 128))


def smem_bytes_conv_f32(bn: int, fused: bool = False) -> int:
    """Dynamic shared memory of the fp32 stride-1 instance (and of the fused
    and the upsample forms, which share its rings): alignment slack, three
    halo stages, the weight ring and the mbarriers."""
    sb = conv_f32_weight_stages(bn, fused)
    return (1024 + CONV_F32_HALO_STAGES * _halo_stage_f32() + sb * 2 * bn * 128
            + _bars_f32(sb, fused))


def bn_f32(cout: int) -> int:
    """The fp32 stride-1 channel tile: 8 for the Cout <= 8 tails, else
    whichever of 80, 64 and 48 leaves the fewest columns empty, the larger on a
    tie."""
    if cout <= 8:
        return 8
    return min((80, 64, 48), key=lambda n: (-(-cout // n) * n - cout, -n))


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, w: int, cin: int, cout: int, sms: int = H100_SMS,
         itemsize: int = 2, fused: bool = False) -> ConvPlan:
    """The kernel's schedule, a pure function of the call's shape (and the
    card's SM count, for the grid).  Channel tile: 8 for the Cout <= 8 tails,
    160 where it divides Cout (320, 640, 1280: no wasted column, and grids of
    128 to 512 tiles that fill 132 SMs), else 128.  One block per SM at most,
    each walking its share of the tiles.  ``itemsize`` 4: the fp32 instance
    (3xTF32), the same rectangles over chunks of 32 channels; channel tile 8
    for the Cout <= 8 tails, else whichever of 80, 64 and 48 leaves the fewest
    columns empty, the larger on a tie (320, 640, 1280: 80; 96: 48; 128 to 512:
    64): its accumulators and a tap's fresh ones are twice as many registers
    as bf16's, so no tile is wider than 80.  A Cin that is no multiple of 32
    ends in a chunk whose channels past Cin the loads zero-fill (in x and in
    both weight copies), so they add nothing.  ``fused``: the fused form
    (``conv_fused.conv3x3_fused``), whose fp32 instance adds a "ready" barrier
    per halo stage (the bf16 rings hold one in every form)."""
    if min(b, h, w, cin, cout) < 1:
        raise ValueError(f"conv3x3 plan: empty call {(b, h, w, cin, cout)}")
    if itemsize not in (2, 4):
        raise ValueError(f"conv3x3 plan: item size {itemsize}; 2 (bf16) or 4 (fp32)")
    f32 = itemsize == 4
    if f32:
        bn = bn_f32(cout)
    elif cout <= 8:
        bn = 8
    elif cout % 160 == 0:
        bn = 160
    else:
        bn = 128
    tiles_y, tiles_x, tiles_n = -(-h // RECT_H), -(-w // RECT_W), -(-cout // bn)
    tiles = b * tiles_y * tiles_x * tiles_n
    chunk = F32_CHUNK if f32 else CHUNK
    return ConvPlan(
        rect=(RECT_H, RECT_W), bn=bn, tiles_y=tiles_y, tiles_x=tiles_x, tiles_n=tiles_n,
        tiles=tiles, grid=min(tiles, sms),
        smem_bytes=smem_bytes_conv_f32(bn, fused) if f32 else smem_bytes(bn),
        box_x=(chunk, RECT_W + 2, RECT_H + 2, 1), box_w=(chunk, 1, bn), chunk=chunk,
        halo_stages=CONV_F32_HALO_STAGES if f32 else HALO_STAGES,
        weight_stages=conv_f32_weight_stages(bn, fused) if f32 else WEIGHT_STAGES,
    )


# The stride-2 form: channel tiles it is instantiated for, its rings.
DOWN2_BN_INSTANCES = (64, 80, 128, 160)
DOWN2_PLANE_STAGES, DOWN2_WEIGHT_STAGES = 2, 4
# Its fp32 instance (csrc/conv3x3_tf32x3.cu, 3xTF32 on wgmma): chunks of
# F32_CHUNK channels, so a pixel's chunk is 128 bytes as in bf16 and the windows
# are the same bytes; a weight stage is one tap's hi and lo copies, as many
# stages as fit beside the windows, at most four.
DOWN2_F32_MAX_WEIGHT_STAGES = 4


@dataclass(frozen=True)
class Down2Plan:
    """The schedule of one stride-2 conv call.  ``rect``, ``tiles_*`` and
    ``grid`` as in :class:`ConvPlan`, over the output's pixels."""

    rect: tuple[int, int]
    bn: int
    tiles_y: int
    tiles_x: int
    tiles_n: int
    tiles: int
    grid: int
    smem_bytes: int
    pad: int  # padding before the first row and column: 1, or 0 for (0, 1)
    # The four staged windows, in shared-memory order: (row parity, column
    # parity) of the plane, the window's (rows, columns), and how far before
    # the tile's first output row and column it starts.
    planes: tuple[tuple[int, int, int, int, int, int], ...]
    box_w: tuple[int, int, int]
    chunk: int = CHUNK  # input channels a stage holds: 64 (bf16) or 32 (fp32)
    weight_stages: int = DOWN2_WEIGHT_STAGES

    def rectangles(self, ho: int, wo: int):
        """(y0, x0) of every rectangle of one output image."""
        return [(ty * self.rect[0], tx * self.rect[1])
                for ty in range(self.tiles_y) for tx in range(self.tiles_x)]

    def tap(self, k: int) -> tuple[int, int]:
        """(plane parity, shift inside the plane's window) of tap ``k`` (0, 1
        or 2) of either axis: output o reads input 2 o + k - pad, the plane
        of that parity at o + floor((k - pad) / 2)."""
        return (k + self.pad) & 1, int(k == 2)


def _down2_window_stage() -> int:
    """Bytes of a stage of four plane windows of 128-byte pixels (64 bf16 or
    32 fp32 channels), each window rounded up to 1024 bytes."""
    windows = [(RECT_H + 1, RECT_W + 1), (RECT_H + 1, RECT_W), (RECT_H, RECT_W + 1),
               (RECT_H, RECT_W)]
    return sum(-(-(r * c * 128) // 1024) * 1024 for r, c in windows)


def smem_bytes_down2(bn: int) -> int:
    """Dynamic shared memory of the stride-2 instance with channel tile
    ``bn``: alignment slack, two stages of four plane windows (each rounded
    up to 1024 bytes), the weight ring and the mbarriers."""
    return (1024 + DOWN2_PLANE_STAGES * _down2_window_stage()
            + DOWN2_WEIGHT_STAGES * bn * CHUNK * 2
            + 8 * (3 * DOWN2_PLANE_STAGES + 2 * DOWN2_WEIGHT_STAGES))


def down2_f32_weight_stages(bn: int) -> int:
    """Weight stages of the fp32 stride-2 instance (one tap's hi and lo
    copies, 2 x bn x 128 bytes, each): as many as fit beside two window
    stages, at most four."""
    bars = 8 * (2 * DOWN2_PLANE_STAGES + 2 * DOWN2_F32_MAX_WEIGHT_STAGES)
    room = SMEM_LIMIT - 1024 - DOWN2_PLANE_STAGES * _down2_window_stage() - bars
    return min(DOWN2_F32_MAX_WEIGHT_STAGES, room // (2 * bn * 128))


def smem_bytes_down2_f32(bn: int) -> int:
    """Dynamic shared memory of the fp32 stride-2 instance: alignment slack,
    two window stages, the weight ring and a full and an empty mbarrier per
    stage."""
    sb = down2_f32_weight_stages(bn)
    return (1024 + DOWN2_PLANE_STAGES * _down2_window_stage() + sb * 2 * bn * 128
            + 8 * (2 * DOWN2_PLANE_STAGES + 2 * sb))


@functools.lru_cache(maxsize=None)
def plan_down2(b: int, h: int, w: int, cin: int, cout: int, asymmetric: bool = False,
               sms: int = H100_SMS, itemsize: int = 2) -> Down2Plan:
    """The stride-2 kernel's schedule for input [b, h, w, cin] (h, w even).
    Output tiles of 8 x 16 pixels; channel tile 160 where it divides Cout,
    else 128, halved (80, 64) where the full one would leave half the SMs
    without a tile: the main path's calls are small (2 x 32 x 32 outputs x 640
    channels is 64 tiles of 160 channels).  ``itemsize`` 4: the fp32
    instance (3xTF32), the same rectangles over chunks of 32 channels, channel
    tile 80 where it divides Cout, else 64 (its accumulators are twice as
    many registers); a Cin that is no multiple of 32 ends in a chunk whose
    channels past Cin the loads zero-fill (in x and in both weight copies), so
    they add nothing."""
    if min(b, h, w, cin, cout) < 1 or h % 2 or w % 2:
        raise ValueError(f"conv3x3_down2 plan: {(b, h, w, cin, cout)} is empty or odd-sized")
    ho, wo, pad = h // 2, w // 2, 0 if asymmetric else 1
    tiles_y, tiles_x = -(-ho // RECT_H), -(-wo // RECT_W)
    if itemsize == 4:  # the registers of the split sums: 80 or 64 (csrc/conv3x3_tf32x3.cu)
        bn = 80 if cout % 80 == 0 else 64
    else:
        bn = 160 if cout % 160 == 0 else 128
        if 2 * b * tiles_y * tiles_x * -(-cout // bn) <= sms:
            bn //= 2
    tiles_n = -(-cout // bn)
    tiles = b * tiles_y * tiles_x * tiles_n
    planes = tuple(
        (py, px, RECT_H + (py == pad), RECT_W + (px == pad), pad * (py == pad), pad * (px == pad))
        for py in (pad, 1 - pad) for px in (pad, 1 - pad))
    if itemsize not in (2, 4):
        raise ValueError(f"conv3x3_down2 plan: item size {itemsize}; 2 (bf16) or 4 (fp32)")
    f32 = itemsize == 4
    chunk = F32_CHUNK if f32 else CHUNK
    return Down2Plan(
        rect=(RECT_H, RECT_W), bn=bn, tiles_y=tiles_y, tiles_x=tiles_x, tiles_n=tiles_n,
        tiles=tiles, grid=min(tiles, sms),
        smem_bytes=smem_bytes_down2_f32(bn) if f32 else smem_bytes_down2(bn), pad=pad,
        planes=planes, box_w=(chunk, 1, bn), chunk=chunk,
        weight_stages=down2_f32_weight_stages(bn) if f32 else DOWN2_WEIGHT_STAGES,
    )


# The upsample form: channel tiles it is instantiated for; its rings are the
# stride-1 kernel's.
UP2_BN_INSTANCES = (128, 160)


@dataclass(frozen=True)
class Up2Plan:
    """The schedule of one upsample-conv call.  ``rect``, ``tiles_y`` and
    ``tiles_x`` as in :class:`ConvPlan`, over the LOW-RES input's pixels; a
    tile is a rectangle, a channel tile and one of the four phases."""

    rect: tuple[int, int]
    bn: int
    tiles_y: int
    tiles_x: int
    tiles_n: int
    phases: int  # 4: output pixel (2i + p, 2j + q) belongs to phase 2p + q
    tiles: int  # all tiles: B * tiles_y * tiles_x * tiles_n * phases
    grid: int
    smem_bytes: int
    box_x: tuple[int, int, int, int]  # the stride-1 halo of the low-res rectangle
    box_w: tuple[int, int, int]  # TMA box over the folded weights [Cin, 16, Cout]
    # (phase 2p + q, tap 2a + b) -> the halo shift (rows, columns) the tap reads
    shifts: tuple[tuple[tuple[int, int], ...], ...]
    chunk: int = CHUNK  # input channels a halo stage holds: 64 (bf16) or 32 (fp32)
    weight_stages: int = WEIGHT_STAGES

    def rectangles(self, h: int, w: int):
        """(y0, x0) of every rectangle of one low-res image."""
        return [(ty * self.rect[0], tx * self.rect[1])
                for ty in range(self.tiles_y) for tx in range(self.tiles_x)]

    def weight_stage(self, phase: int, tap: int) -> int:
        """The index of (phase, tap) in the folded weights' middle dimension."""
        return 4 * phase + tap

    def tile_at(self, t):
        """(image, y0, x0, first channel, phase) of tile ``t`` of the kernel's
        walk: the phase fastest, then the channel tile, the rectangle's
        column, its row, the image.  ``t`` may be an integer array."""
        u, phase = t // self.phases, t % self.phases
        m, n = u // self.tiles_n, u % self.tiles_n
        row, tx = m // self.tiles_x, m % self.tiles_x
        return (row // self.tiles_y, (row % self.tiles_y) * self.rect[0], tx * self.rect[1],
                n * self.bn, phase)


@functools.lru_cache(maxsize=None)
def plan_up2(b: int, h: int, w: int, cin: int, cout: int, sms: int = H100_SMS,
             itemsize: int = 2) -> Up2Plan:
    """The upsample kernel's schedule for input [b, h, w, cin].  Output pixel
    (2i + p, 2j + q) is a 2 x 2 conv of the low-res input: tap (a, b) of phase
    (p, q) reads x[i - 1 + a + p, j - 1 + b + q], which is shift (a + p, b + q)
    of the stride-1 halo of a low-res rectangle, so one staged halo serves
    every tap of every phase.  Tiles of 8 x 16 low-res pixels x ``bn`` channels
    x one phase (4 taps, K = 4 Cin); channel tile 160 where it divides Cout,
    else 128.  Every main-path call is at least 512 tiles, 3.9 rounds of 132
    SMs, so no halved channel tile is needed.  ``itemsize`` 4: the fp32
    instance (3xTF32), the stride-1 fp32 instance's rings and channel tiles
    (:func:`bn_f32`) over chunks of 32 channels."""
    if min(b, h, w, cin, cout) < 1:
        raise ValueError(f"conv3x3_up2 plan: empty call {(b, h, w, cin, cout)}")
    if itemsize not in (2, 4):
        raise ValueError(f"conv3x3_up2 plan: item size {itemsize}; 2 (bf16) or 4 (fp32)")
    f32 = itemsize == 4
    bn = bn_f32(cout) if f32 else 160 if cout % 160 == 0 else 128
    chunk = F32_CHUNK if f32 else CHUNK
    tiles_y, tiles_x, tiles_n = -(-h // RECT_H), -(-w // RECT_W), -(-cout // bn)
    tiles = b * tiles_y * tiles_x * tiles_n * 4
    shifts = tuple(tuple((a + p, c + q) for a in (0, 1) for c in (0, 1))
                   for p in (0, 1) for q in (0, 1))
    return Up2Plan(
        rect=(RECT_H, RECT_W), bn=bn, tiles_y=tiles_y, tiles_x=tiles_x, tiles_n=tiles_n,
        phases=4, tiles=tiles, grid=min(tiles, sms),
        smem_bytes=smem_bytes_conv_f32(bn) if f32 else smem_bytes(bn),
        box_x=(chunk, RECT_W + 2, RECT_H + 2, 1), box_w=(chunk, 1, bn), shifts=shifts,
        chunk=chunk, weight_stages=conv_f32_weight_stages(bn) if f32 else WEIGHT_STAGES,
    )


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def sm_count_of(t: torch.Tensor) -> int:
    """The SM count of the card that holds ``t``, for a plan's grid."""
    if t.device.type != "cuda":
        raise ValueError(f"a kernel's plan needs a tensor on a CUDA card; got {t.device}")
    index = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return _sm_count(index)


def plan_for(x: torch.Tensor, cout: int, fused: bool = False) -> ConvPlan:
    """The stride-1 plan of a call on the card that holds ``x``, for its
    dtype (``fused``: the fused form's)."""
    return plan(*x.shape, cout, sm_count_of(x), x.element_size(), fused)


def plan_down2_for(x: torch.Tensor, cout: int, asymmetric: bool) -> Down2Plan:
    """The stride-2 plan of a call on the card that holds ``x``, for its
    dtype."""
    return plan_down2(*x.shape, cout, bool(asymmetric), sm_count_of(x), x.element_size())


def plan_up2_for(x: torch.Tensor, cout: int) -> Up2Plan:
    """The upsample plan of a call on the card that holds ``x``, for its
    dtype."""
    return plan_up2(*x.shape, cout, sm_count_of(x), x.element_size())


def supports(x_shape, w_shape) -> bool:
    """The gate: the same calls reach the kernel as reach the Pallas conv in
    the JAX package's bf16 configuration (3x3, Cin >= 64).  The TPU kernel's
    VMEM tile budget admits every such call on the main path and does not
    carry over.  Cin must also be a multiple of 8 (16-byte rows); every
    model the repo supports satisfies it."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    cin = x_shape[-1]
    cout, wcin, kh, kw = w_shape
    return (kh, kw) == (3, 3) and wcin == cin and cin >= 64 and cin % 8 == 0


def conv3x3_plain(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 conv on an upcast, fp32
    bias and SiLU, one rounding to x.dtype.  TF32 must be off for this to be
    an fp32 reference on a card (chip_smoke.py sets it)."""
    out = F.conv2d(
        x.permute(0, 3, 1, 2).float(), weight.float(), padding=1
    ).permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias.float()
    if act == "silu":
        out = F.silu(out)
    elif act is not None:
        raise ValueError(f"unsupported activation {act!r}")
    return out.to(x.dtype).contiguous()


def conv3x3_tiled_plain(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    prenorm: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    act: Optional[str] = None,
    skip: Optional[torch.Tensor] = None,
    halo_batch_shift: int = 0,
) -> torch.Tensor:
    """The kernel's schedule in plain PyTorch, for tests only: per rectangle
    of :func:`plan` and per 64-channel chunk, the halo gathered with zero
    fill, the fused prologue applied to in-image elements alone (rounded to
    x.dtype), nine shifted taps accumulated in fp32, then the epilogue (bias
    [Cout] or [B, Cout], SiLU, skip, one rounding).  It differs from
    ``conv3x3_plain`` / ``conv3x3_fused_plain`` only in the order of the
    sums.  ``halo_batch_shift`` plants a fault: a rectangle at an image's top
    edge reads its halo row above the image from the image ``shift`` places
    before, as a rectangle that straddles two images would."""
    b, h, w, cin = x.shape
    cout = weight.shape[0]
    pl = plan(b, h, w, cin, cout)
    rh, rw = pl.rect
    wf = weight.float()  # [Cout, Cin, 3, 3]
    out = torch.zeros((b, h, w, cout), dtype=torch.float32, device=x.device)
    for bi in range(b):
        for y0, x0 in pl.rectangles(h, w):
            acc = torch.zeros((rh, rw, cout), dtype=torch.float32, device=x.device)
            ys, xs = max(0, y0 - 1), max(0, x0 - 1)
            ye, xe = min(h, y0 + rh + 1), min(w, x0 + rw + 1)
            for c0 in range(0, cin, CHUNK):
                c1 = min(cin, c0 + CHUNK)
                inside = x[bi, ys:ye, xs:xe, c0:c1]
                if prenorm is not None:
                    sc, sh = prenorm[0].float()[bi, c0:c1], prenorm[1].float()[bi, c0:c1]
                    inside = F.silu(inside.float() * sc + sh).to(x.dtype)
                halo = torch.zeros((rh + 2, rw + 2, c1 - c0), dtype=torch.float32,
                                   device=x.device)
                halo[ys - y0 + 1:ye - y0 + 1, xs - x0 + 1:xe - x0 + 1] = inside.float()
                if halo_batch_shift and y0 == 0:
                    halo[0, xs - x0 + 1:xe - x0 + 1] = x[
                        (bi - halo_batch_shift) % b, h - 1, xs:xe, c0:c1].float()
                for dy in range(3):
                    for dx in range(3):
                        acc += halo[dy:dy + rh, dx:dx + rw] @ wf[:, c0:c1, dy, dx].T
            out[bi, y0:y0 + rh, x0:x0 + rw] = acc[:h - y0, :w - x0]
    if bias is not None:
        bf = bias.float()
        out = out + (bf[:, None, None, :] if bf.dim() == 2 else bf)
    if act == "silu":
        out = F.silu(out)
    elif act is not None:
        raise ValueError(f"unsupported activation {act!r}")
    if skip is not None:
        out = out + skip.float()
    return out.to(x.dtype).contiguous()


def conv3x3_tiled_plain_f32(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
    chunks_skipped: int = 0,
    prenorm: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    skip: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The fp32 instance's schedule (:func:`plan` at item size 4) in plain
    PyTorch, for tests only, plain or fused: per rectangle and per chunk of 32
    input channels, the halo gathered with zero fill and the chunk's weights
    zero-filled past Cin (as the kernel's loads fill both operands), the fused
    prologue ``prenorm`` applied to its in-image elements alone, then per tap a
    shifted rectangle of the halo times the tap's weights, its own sum (the
    kernel's fresh accumulator) added into the tile's in fp32; then bias
    [Cout] or [B, Cout], SiLU and the skip in fp32.  It differs from
    :func:`conv3x3_plain` (``conv_fused.conv3x3_fused_plain``) only in the
    order of the sums.  ``chunks_skipped`` plants a fault: the chunk loop stops
    that many chunks short."""
    b, h, w, cin = x.shape
    cout = weight.shape[0]
    pl = plan(b, h, w, cin, cout, itemsize=4)
    rh, rw, chunk = *pl.rect, pl.chunk
    xf, wf = x.float(), weight.float()
    out = torch.zeros((b, h, w, cout), dtype=torch.float32, device=x.device)
    for bi in range(b):
        for y0, x0 in pl.rectangles(h, w):
            acc = torch.zeros((rh, rw, cout), dtype=torch.float32, device=x.device)
            ys, xs = max(0, y0 - 1), max(0, x0 - 1)
            ye, xe = min(h, y0 + rh + 1), min(w, x0 + rw + 1)
            for c0 in range(0, cin - chunks_skipped * chunk, chunk):
                c1 = min(cin, c0 + chunk)
                inside = xf[bi, ys:ye, xs:xe, c0:c1]
                if prenorm is not None:
                    sc, sh = prenorm[0].float()[bi, c0:c1], prenorm[1].float()[bi, c0:c1]
                    inside = F.silu(inside * sc + sh)
                halo = torch.zeros((rh + 2, rw + 2, chunk), dtype=torch.float32,
                                   device=x.device)
                halo[ys - y0 + 1:ye - y0 + 1, xs - x0 + 1:xe - x0 + 1, :c1 - c0] = inside
                wchunk = torch.zeros((cout, chunk, 3, 3), dtype=torch.float32, device=x.device)
                wchunk[:, :c1 - c0] = wf[:, c0:c1]
                for dy in range(3):
                    for dx in range(3):
                        acc += halo[dy:dy + rh, dx:dx + rw] @ wchunk[:, :, dy, dx].T
            out[bi, y0:y0 + rh, x0:x0 + rw] = acc[:h - y0, :w - x0]
    if bias is not None:
        bf = bias.float()
        out = out + (bf[:, None, None, :] if bf.dim() == 2 else bf)
    if act == "silu":
        out = F.silu(out)
    elif act is not None:
        raise ValueError(f"unsupported activation {act!r}")
    if skip is not None:
        out = out + skip.float()
    return out.contiguous()


def check_split(name: str, w_split, weight: torch.Tensor) -> tuple[int, int]:
    """The fp32 kernels' weight operands: ``w_split`` must be
    ``conv_fused.split_tf32(weight)``, two fp32 tensors of the weight's shape
    in channels_last memory on its device; their pointers."""
    if w_split is None or len(w_split) != 2 or any(
            t.shape != weight.shape or t.dtype != torch.float32 or t.device != weight.device
            or not t.is_contiguous(memory_format=torch.channels_last) or t.data_ptr() % 16
            for t in w_split):
        raise ValueError(f"{name}: w_split must be split_tf32(weight), fp32 in channels_last "
                         "memory on the weight's device")
    return w_split[0].data_ptr(), w_split[1].data_ptr()


KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def check_dtypes(name: str, *tensors: torch.Tensor) -> None:
    """The kernels take bf16 (the default mode) or fp32 (the quality mode),
    all operands of one dtype."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or dtypes.pop() not in KERNEL_DTYPES:
        raise TypeError(f"{name} kernel takes bf16 or fp32 tensors of one dtype; got "
                        f"{', '.join(str(t.dtype) for t in tensors)}")


def _check(x, weight, bias):
    check_dtypes("conv3x3", x, weight)
    if weight.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError("conv3x3: x, weight and bias must be on one device")
    if not supports(tuple(x.shape), tuple(weight.shape)):
        raise ValueError(
            f"conv3x3 kernel does not take x {tuple(x.shape)}, "
            f"weight {tuple(weight.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError("conv3x3: x must be a contiguous NHWC tensor")
    if not weight.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv3x3: weight must be in channels_last memory")
    if bias is not None and (bias.dtype != torch.float32 or not bias.is_contiguous()):
        raise ValueError("conv3x3: bias must be a contiguous fp32 vector")
    if x.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError("conv3x3: x and weight must be 16-byte aligned")


def conv3x3(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    act: Optional[str] = None,
    w_split: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """3x3 SAME conv: x [B, H, W, Cin], weight [Cout, Cin, 3, 3] in
    channels_last memory, both bf16 or both fp32, bias [Cout] -> [B, H, W,
    Cout] in x's dtype.  fp32 on the card runs the 3xTF32 instance on
    ``w_split``, the weight's TF32 hi and lo copies
    (``conv_fused.split_tf32(weight)``, which the conv modules make once per
    weight version); an fp32 call on the card without them raises.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises; either raises on a dtype the kernels do not take."""
    check_dtypes("conv3x3", x, weight)
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias, act)
    if act not in (None, "silu"):
        raise ValueError(f"unsupported activation {act!r}")
    bias = None if bias is None else bias.float().contiguous()
    _check(x, weight, bias)
    from fastedit_tpu_torch.ops.build import library

    global launches, launches_f32
    b, h, w, cin = x.shape
    cout = weight.shape[0]
    f32 = x.dtype == torch.float32
    weights = check_split("conv3x3", w_split, weight) if f32 else (weight.data_ptr(),)
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    pl = plan_for(x, cout)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (x.data_ptr(), *weights, None if bias is None else bias.data_ptr(),
                out.data_ptr(), b, h, w, cin, cout, int(act == "silu"), pl.bn, pl.grid, stream)
        if f32:
            err = library("conv3x3_tf32x3").conv3x3_tf32x3(*args)
        else:
            err = library("conv3x3").conv3x3_bf16(*args)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: CUDA error {err}")
    if f32:
        launches_f32 += 1
    else:
        launches += 1
    return out
