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
tiles stage windows of the input's four parity planes instead of one halo.

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

# Launches of the CUDA kernel since the last reset (chip_smoke.py resets it).
launches = 0


# The stride-1 kernel's geometry (csrc/conv3x3.cu holds the same constants).
RECT_H, RECT_W = 8, 16  # output pixels per tile
CHUNK = 64  # input channels per staged halo: 128 bytes, one swizzle row
HALO_STAGES, WEIGHT_STAGES = 3, 6
BN_INSTANCES = (8, 128, 160)  # channel tiles the kernel is instantiated for
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on an H100
H100_SMS = 132


@dataclass(frozen=True)
class ConvPlan:
    """The schedule of one stride-1 conv call (plain or fused)."""

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


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, w: int, cin: int, cout: int, sms: int = H100_SMS) -> ConvPlan:
    """The kernel's schedule, a pure function of the call's shape (and the
    card's SM count, for the grid).  Channel tile: 8 for the Cout <= 8 tails,
    160 where it divides Cout (320, 640, 1280: no wasted column, and grids of
    128 to 512 tiles that fill 132 SMs), else 128.  One block per SM at most,
    each walking its share of the tiles."""
    if min(b, h, w, cin, cout) < 1:
        raise ValueError(f"conv3x3 plan: empty call {(b, h, w, cin, cout)}")
    if cout <= 8:
        bn = 8
    elif cout % 160 == 0:
        bn = 160
    else:
        bn = 128
    tiles_y, tiles_x, tiles_n = -(-h // RECT_H), -(-w // RECT_W), -(-cout // bn)
    tiles = b * tiles_y * tiles_x * tiles_n
    return ConvPlan(
        rect=(RECT_H, RECT_W), bn=bn, tiles_y=tiles_y, tiles_x=tiles_x, tiles_n=tiles_n,
        tiles=tiles, grid=min(tiles, sms), smem_bytes=smem_bytes(bn),
        box_x=(CHUNK, RECT_W + 2, RECT_H + 2, 1), box_w=(CHUNK, 1, bn),
    )


# The stride-2 form: channel tiles it is instantiated for, its rings.
DOWN2_BN_INSTANCES = (64, 80, 128, 160)
DOWN2_PLANE_STAGES, DOWN2_WEIGHT_STAGES = 2, 4


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

    def rectangles(self, ho: int, wo: int):
        """(y0, x0) of every rectangle of one output image."""
        return [(ty * self.rect[0], tx * self.rect[1])
                for ty in range(self.tiles_y) for tx in range(self.tiles_x)]

    def tap(self, k: int) -> tuple[int, int]:
        """(plane parity, shift inside the plane's window) of tap ``k`` (0, 1
        or 2) of either axis: output o reads input 2 o + k - pad, the plane
        of that parity at o + floor((k - pad) / 2)."""
        return (k + self.pad) & 1, int(k == 2)


def smem_bytes_down2(bn: int) -> int:
    """Dynamic shared memory of the stride-2 instance with channel tile
    ``bn``: alignment slack, two stages of four plane windows (each rounded
    up to 1024 bytes), the weight ring and the mbarriers."""
    windows = [(RECT_H + 1, RECT_W + 1), (RECT_H + 1, RECT_W), (RECT_H, RECT_W + 1),
               (RECT_H, RECT_W)]
    stage = sum(-(-(r * c * CHUNK * 2) // 1024) * 1024 for r, c in windows)
    return (1024 + DOWN2_PLANE_STAGES * stage + DOWN2_WEIGHT_STAGES * bn * CHUNK * 2
            + 8 * (3 * DOWN2_PLANE_STAGES + 2 * DOWN2_WEIGHT_STAGES))


@functools.lru_cache(maxsize=None)
def plan_down2(b: int, h: int, w: int, cin: int, cout: int, asymmetric: bool = False,
               sms: int = H100_SMS) -> Down2Plan:
    """The stride-2 kernel's schedule for input [b, h, w, cin] (h, w even).
    Output tiles of 8 x 16 pixels; channel tile 160 where it divides Cout,
    else 128, halved (80, 64) where the full one would leave half the SMs
    without a tile: the main path's calls are small (2 x 32 x 32 outputs x 640
    channels is 64 tiles of 160 channels)."""
    if min(b, h, w, cin, cout) < 1 or h % 2 or w % 2:
        raise ValueError(f"conv3x3_down2 plan: {(b, h, w, cin, cout)} is empty or odd-sized")
    ho, wo, pad = h // 2, w // 2, 0 if asymmetric else 1
    tiles_y, tiles_x = -(-ho // RECT_H), -(-wo // RECT_W)
    bn = 160 if cout % 160 == 0 else 128
    if 2 * b * tiles_y * tiles_x * -(-cout // bn) <= sms:
        bn //= 2
    tiles_n = -(-cout // bn)
    tiles = b * tiles_y * tiles_x * tiles_n
    planes = tuple(
        (py, px, RECT_H + (py == pad), RECT_W + (px == pad), pad * (py == pad), pad * (px == pad))
        for py in (pad, 1 - pad) for px in (pad, 1 - pad))
    return Down2Plan(
        rect=(RECT_H, RECT_W), bn=bn, tiles_y=tiles_y, tiles_x=tiles_x, tiles_n=tiles_n,
        tiles=tiles, grid=min(tiles, sms), smem_bytes=smem_bytes_down2(bn), pad=pad,
        planes=planes, box_w=(CHUNK, 1, bn),
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


def plan_for(x: torch.Tensor, cout: int) -> ConvPlan:
    """The stride-1 plan of a call on the card that holds ``x``."""
    return plan(*x.shape, cout, sm_count_of(x))


def plan_down2_for(x: torch.Tensor, cout: int, asymmetric: bool) -> Down2Plan:
    """The stride-2 plan of a call on the card that holds ``x``."""
    return plan_down2(*x.shape, cout, bool(asymmetric), sm_count_of(x))


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


def _check(x, weight, bias):
    if x.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16:
        raise TypeError(
            f"conv3x3 kernel takes bf16 tensors; got {x.dtype}, {weight.dtype} "
            "(fp32 quality mode is a later slice)"
        )
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
) -> torch.Tensor:
    """3x3 SAME conv: x [B, H, W, Cin] bf16, weight [Cout, Cin, 3, 3] bf16 in
    channels_last memory, bias [Cout] -> [B, H, W, Cout] bf16.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias, act)
    if act not in (None, "silu"):
        raise ValueError(f"unsupported activation {act!r}")
    bias = None if bias is None else bias.float().contiguous()
    _check(x, weight, bias)
    from fastedit_tpu_torch.ops.build import library

    fn = library("conv3x3").conv3x3_bf16
    b, h, w, cin = x.shape
    cout = weight.shape[0]
    pl = plan_for(x, cout)
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), weight.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            b, h, w, cin, cout, int(act == "silu"), pl.bn, pl.grid, stream,
        )
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out
