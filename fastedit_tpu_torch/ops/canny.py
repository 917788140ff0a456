"""Canny prepare: the ControlNet-Canny edge map and the VAE input, on the card
as CUDA kernels, with the plain PyTorch versions beside them.

Bit-exact to the JAX package's ``canny_np`` (and so to cv2 5.0):
  * RGB -> gray with cv2's shift-15 fixed point:
    ``(R*9798 + G*19235 + B*3735 + 2^14) >> 15``;
  * 3x3 Sobel on integers with replicate border, L1 magnitude, thresholds
    floored (and swapped if low > high: :func:`floor_thresholds`, the one
    place that does it), compared strictly;
  * non-maximum suppression with cv2's integer sector test (TG22 = 13573,
    shift 15) and its tie rules: horizontal keeps on ``m > left and
    m >= right``, vertical on ``m > up and m >= down``, diagonals strict on
    both sides, the diagonal chosen by the sign bit of ``gx ^ gy``;
  * double threshold and 8-connected hysteresis: the candidates connected
    to a strong pixel through candidates.

On the card, prepare (the JAX package's ``prepare_one`` over a batch, which
computes Canny in XLA inside its edit program) is one launch of one kernel,
``canny_kernel`` in ``csrc/canny.cu``, with no host synchronisation, so the
editor captures it as the first graph of an edit's chain
(``pipeline/graphs.py``).  A persistent grid (:func:`plan`) walks the
32 x 32 tiles of the batch: per tile the RGB rows staged in shared memory,
gray, Sobel, NMS and the double threshold into a class map that stays there,
the VAE input ``f / 127.5 - 1`` through a 256-entry table
(:func:`vae_table`), and a tile-local union-find; after a grid-wide barrier
the unions across tile edges; after a second one each candidate's root and
the control image ``[B, H, W, 3]`` in {0, 1}.  The thresholds are int32
device tensors, already floored and ordered (:func:`threshold_tensors`), so
one graph serves every threshold.  Three entries share the device code:

* :func:`prepare`: image -> (control, VAE input), what an edit launches;
* :func:`canny_front`: image -> (class map 0, :data:`WEAK`, :data:`STRONG`;
  VAE input), the union-find skipped;
* :func:`canny_hysteresis`: class map -> control, for the stress masks and
  the conformance checks.

The plain versions (:func:`prepare_plain`, :func:`canny_front_plain`,
:func:`canny_hysteresis_plain`, and :func:`canny`, the edges as uint8) are
for a CPU tensor and for comparisons (``flags.override(plain_versions=True)``);
like the kernels they take ordered thresholds, but :func:`canny`, which
floors and orders its own.  Their hysteresis grows the strong pixels by
masked dilation and reads on the host, every 8 dilations, whether it has
reached its fixed point.  :func:`hysteresis_schedule` is the kernel's
hysteresis step by step in numpy (its node ids, its tiles in the persistent
order for a given grid, its edge unions and their skipped repeats), for the
tests only.  :func:`canny_np` is the same algorithm in plain numpy with a
stack-based flood fill for the hysteresis, the port's own copy of the JAX
package's reference (``tools/conformance.py`` holds the card to it bit for
bit).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

_GRAY_COEF = (9798, 19235, 3735)
_GRAY_SHIFT = 15
_CANNY_SHIFT = 15
_TG22 = 13573
WEAK, STRONG = 1, 2  # the class map's values (0: not a candidate)
NONE = -1  # the kernel's label of a pixel that is no candidate

# The kernel's geometry (csrc/canny.cu): a tile's side, its two-pixel halo, a
# staged row of 128 bytes, and the shared memory of a block (two staged
# tiles, the staged rows' offsets, gray, magnitude, local labels, class map,
# the VAE table, the tiles in hand).
TILE = 32
HALO = 2
ROW_BYTES = 128
_GT, _MT = TILE + 2 * HALO, TILE + 2


def smem_bytes(itemsize: int) -> int:
    """Shared memory of a block of the kernel whose outputs have ``itemsize``
    bytes (2: bf16, 4: fp32), as ``canny_smem_bytes`` gives it: the struct's
    fields, then its size rounded up to its 16-byte alignment."""
    fields = (2 * _GT * ROW_BYTES + 4 * _GT + 4 * _GT * _GT + 4 * _MT * _MT + 4 * TILE * TILE
              + TILE * TILE + 256 * itemsize + 4 * 2)
    return -(-fields // 16) * 16


# Launches since the last reset (chip_smoke.py resets them), by entry and by
# the outputs' dtype: <name> in bf16, <name>_f32 in fp32.
launches = {f"{name}{sfx}": 0 for name in ("canny_prepare", "canny_front", "canny_hysteresis")
            for sfx in ("", "_f32")}


@dataclass(frozen=True)
class CannyPlan:
    """The kernel's schedule for a batch: ``grid`` blocks.  In the unions
    across tile edges and the write block k takes the tiles k, k + grid, ...
    (tile t: image t // (tiles_y tiles_x), row of tiles (t // tiles_x) %
    tiles_y, column t % tiles_x); in the first phase its first tile is k and
    the rest come from a counter, as the blocks ask for them."""

    b: int
    h: int
    w: int
    tiles_x: int
    tiles_y: int
    grid: int
    itemsize: int

    @property
    def ntiles(self) -> int:
        return self.b * self.tiles_x * self.tiles_y

    @property
    def tiles_per_block(self) -> int:
        """The most tiles a block takes in the unions across tile edges and
        the write."""
        return -(-self.ntiles // self.grid)

    @property
    def smem_bytes(self) -> int:
        return smem_bytes(self.itemsize)

    def tiles_of(self, block: int) -> range:
        return range(block, self.ntiles, self.grid)

    def tile(self, t: int) -> tuple[int, int, int]:
        """Tile t's (image, y0, x0)."""
        b, r = divmod(t, self.tiles_x * self.tiles_y)
        ty, tx = divmod(r, self.tiles_x)
        return b, ty * TILE, tx * TILE


@functools.lru_cache(maxsize=256)
def plan(b: int, h: int, w: int, slots: int, itemsize: int = 2) -> CannyPlan:
    """The schedule of a [b, h, w] batch on a card that holds ``slots``
    blocks at once: each block takes ceil(tiles / slots) tiles or one
    fewer, in as few blocks as that allows (every block resident, so the
    grid-wide barriers cannot wait on a block that never runs)."""
    if min(b, h, w) < 1 or slots < 1:
        raise ValueError(f"canny plan: batch [{b}, {h}, {w}] on {slots} resident blocks")
    if itemsize not in (2, 4):
        raise ValueError(f"canny plan: item size {itemsize}; the kernel writes bf16 or fp32")
    tiles_x, tiles_y = -(-w // TILE), -(-h // TILE)
    tiles = b * tiles_x * tiles_y
    per_block = -(-tiles // slots)
    return CannyPlan(b, h, w, tiles_x, tiles_y, -(-tiles // per_block), itemsize)


_slots: dict[int, int] = {}


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def slots_of(device: torch.device) -> int:
    """Blocks the card holds at once (the kernel's ``canny_slots``: SMs x
    blocks per SM, the least over its entries), once per device."""
    from fastedit_tpu_torch.ops.build import library

    lib = library("canny")  # built at first use (raises without nvcc)
    index = _index(device)
    if index not in _slots:
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = lib.canny_slots(ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"canny_slots failed: CUDA error {err}")
        _slots[index] = out.value
    return _slots[index]


def plan_for(t: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> CannyPlan:
    """The plan for an image [B, H, W, 3] or class map [B, H, W] on its card."""
    b, h, w = t.shape[:3]
    return plan(b, h, w, slots_of(t.device), 4 if dtype == torch.float32 else 2)


def floor_thresholds(low, high) -> tuple[int, int]:
    """``canny_np``'s thresholds: each floored, the smaller first."""
    lo, hi = int(np.floor(float(low))), int(np.floor(float(high)))
    return min(lo, hi), max(lo, hi)


def threshold_tensors(low, high, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(low, high) as 0-dim int32 tensors on ``device``, floored and ordered
    on the host (:func:`floor_thresholds`); to a card from pinned memory,
    without a sync."""
    t = torch.tensor(floor_thresholds(low, high), dtype=torch.int32)
    if torch.device(device).type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t[0], t[1]


# ------------------------------------------------------------ plain versions


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] in [0, 255] -> [..., H, W] int32, cv2 rounding."""
    u = torch.round(img).int() if img.is_floating_point() else img.int()
    acc = (
        u[..., 0] * _GRAY_COEF[0]
        + u[..., 1] * _GRAY_COEF[1]
        + u[..., 2] * _GRAY_COEF[2]
        + (1 << (_GRAY_SHIFT - 1))
    )
    return acc >> _GRAY_SHIFT


def _shifts(x: torch.Tensor, replicate: bool):
    """sh(dy, dx)[..., y, x] = x[..., y+dy, x+dx], edge-replicated or zero."""
    h, w = x.shape[-2:]
    if replicate:
        rows = torch.arange(-1, h + 1, device=x.device).clamp(0, h - 1)
        cols = torch.arange(-1, w + 1, device=x.device).clamp(0, w - 1)
        p = x[..., rows, :][..., :, cols]
    else:
        p = F.pad(x, (1, 1, 1, 1))

    def sh(dy, dx):
        return p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    return sh


def classes_plain(image: torch.Tensor, low, high) -> torch.Tensor:
    """[B, H, W, 3] in [0, 255] -> the class map, uint8 [B, H, W]: 0,
    :data:`WEAK` (a candidate: kept by NMS, above the low threshold) or
    :data:`STRONG` (also above the high one).  ``low <= high``: ints or
    0-dim integer tensors (:func:`threshold_tensors`; a tensor on the card is
    not read on the host)."""
    gray = rgb_to_gray(image)

    sh = _shifts(gray, replicate=True)
    gx = (sh(-1, 1) - sh(-1, -1)) + 2 * (sh(0, 1) - sh(0, -1)) + (sh(1, 1) - sh(1, -1))
    gy = (sh(1, -1) - sh(-1, -1)) + 2 * (sh(1, 0) - sh(-1, 0)) + (sh(1, 1) - sh(-1, 1))
    mag = gx.abs() + gy.abs()

    ax = gx.abs()
    ay = gy.abs() << _CANNY_SHIFT
    tg22x = ax * _TG22
    tg67x = tg22x + ((2 * ax) << _CANNY_SHIFT)
    m = _shifts(mag, replicate=False)
    horiz = ay < tg22x
    vert = ay > tg67x
    s_neg = torch.bitwise_xor(gx, gy) < 0
    keep_h = (mag > m(0, -1)) & (mag >= m(0, 1))
    keep_v = (mag > m(-1, 0)) & (mag >= m(1, 0))
    keep_d1 = (mag > m(-1, -1)) & (mag > m(1, 1))
    keep_d2 = (mag > m(-1, 1)) & (mag > m(1, -1))
    keep = torch.where(
        horiz, keep_h, torch.where(vert, keep_v, torch.where(s_neg, keep_d2, keep_d1))
    )
    cand = keep & (mag > low)
    strong = cand & (mag > high)
    return cand.to(torch.uint8) + strong.to(torch.uint8)


def hysteresis_plain(cls: torch.Tensor) -> torch.Tensor:
    """Class map [B, H, W] -> the edges, bool [B, H, W]: the strong pixels
    grown through 8-connected candidates to a fixed point, 8 dilation steps
    between convergence checks (read on the host)."""
    cur = cls == STRONG
    weak_f = (cls != 0).float()
    while True:
        grown = cur.float()
        for _ in range(8):
            dil = F.max_pool2d(grown[:, None], 3, stride=1, padding=1)[:, 0]
            grown = torch.maximum(dil * weak_f, grown)
        grown = grown > 0
        if torch.equal(grown, cur):
            return cur
        cur = grown


def canny_front_plain(image: torch.Tensor, low, high, dtype: torch.dtype):
    """:func:`canny_front`'s plain version: (class map, VAE input).  The VAE
    input ``f / 127.5 - 1`` is an fp32 division and subtraction, each
    rounded to nearest, then one rounding to ``dtype``.  The divisor is a
    tensor on the image's device: PyTorch divides a CUDA tensor by a Python
    number as a multiplication by its reciprocal, which differs in the last
    bit."""
    f = image.float()
    return classes_plain(image, low, high), (f / f.new_full((), 127.5) - 1.0).to(dtype)


def canny_hysteresis_plain(cls: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """:func:`canny_hysteresis`'s plain version: control [B, H, W, 3]."""
    edges = hysteresis_plain(cls).to(dtype)
    return edges[..., None].expand(*edges.shape, 3).contiguous()


def prepare_plain(image: torch.Tensor, low, high, dtype: torch.dtype):
    """:func:`prepare`'s plain version: (control, VAE input)."""
    cls, vae_in = canny_front_plain(image, low, high, dtype)
    return canny_hysteresis_plain(cls, dtype), vae_in


def vae_table(dtype: torch.dtype) -> torch.Tensor:
    """The VAE input of each byte value, [256] in ``dtype``: the kernel's
    table, the plain version's arithmetic (``v / 127.5 - 1`` in fp32, then one
    rounding)."""
    f = torch.arange(256, dtype=torch.float32)
    return (f / f.new_full((), 127.5) - 1.0).to(dtype)


def hysteresis_schedule(cls: np.ndarray, grid: int) -> np.ndarray:
    """The kernel's hysteresis step by step, for the tests: class map uint8
    [B, H, W] -> edges, bool [B, H, W].  The tiles in the order of a grid of
    ``grid`` blocks (:class:`CannyPlan`); per tile the local union-find with
    the kernel's node ids (strong pixel p node p, weak node TPX + p, every
    link to the smaller root): each run of a row linked to its least node,
    each pair of touching runs of two rows united once, and each pixel's
    label, its local root's global id or :data:`NONE` (the kernel writes a
    candidate that is no local root as -2 - its local root's tile-local node,
    the same root); per tile edge, lane by lane, the unions with the backward
    neighbours in other tiles, a pair skipped as the kernel skips it; then
    each label's root, strong where it is below N."""
    b, h, w = cls.shape
    n, tpx = b * h * w, TILE * TILE
    p = CannyPlan(b, h, w, -(-w // TILE), -(-h // TILE), grid, 2)
    labels = np.full(n, NONE, np.int64)

    def find(lab, m, i):
        while lab[i - m if i >= m else i] != i:
            i = lab[i - m if i >= m else i]
        return i

    def unite(lab, m, x, y):
        x, y = find(lab, m, x), find(lab, m, y)
        if x != y:
            lo, hi = min(x, y), max(x, y)
            lab[hi - m if hi >= m else hi] = lo

    def pixel(bi, y, x):
        return (bi * h + y) * w + x

    for block in range(grid):  # phase 1
        for t in p.tiles_of(block):
            bi, y0, x0 = p.tile(t)
            cl = np.zeros((TILE, TILE), np.uint8)
            part = cls[bi, y0:y0 + TILE, x0:x0 + TILE]
            cl[:part.shape[0], :part.shape[1]] = part
            cl = cl.reshape(-1)
            lab = np.zeros(tpx, np.int64)
            for r in range(TILE):  # each run of a row linked to its least node
                row = cl[r * TILE:(r + 1) * TILE]
                c = 0
                while c < TILE:
                    first = c
                    while c < TILE and row[c]:
                        c += 1
                    if c > first:
                        strong = np.flatnonzero(row[first:c] == STRONG)
                        root = r * TILE + first + (strong[0] if len(strong) else 0)
                        lab[r * TILE + first:r * TILE + c] = root + (0 if len(strong) else tpx)
                    c += 1
            for r in range(1, TILE):  # each pair of touching runs of two rows, once
                row, up = cl[r * TILE:(r + 1) * TILE] != 0, cl[(r - 1) * TILE:r * TILE] != 0
                for c in np.flatnonzero(row):
                    i = r * TILE + c
                    me = i if cl[i] == STRONG else i + tpx
                    first, nw = c == 0 or not row[c - 1], c > 0 and up[c - 1]

                    def above(x):
                        j = (r - 1) * TILE + x
                        return j if cl[j] == STRONG else j + tpx

                    if first and nw:
                        unite(lab, tpx, me, above(c - 1))
                    if first and up[c] and not nw:
                        unite(lab, tpx, me, above(c))
                    if c < TILE - 1 and up[c + 1] and not up[c]:
                        unite(lab, tpx, me, above(c + 1))
            for i in range(tpx):
                r, c = divmod(i, TILE)
                if y0 + r >= h or x0 + c >= w:
                    continue
                if cl[i]:
                    root = find(lab, tpx, i if cl[i] == STRONG else i + tpx)
                    rs = root - tpx if root >= tpx else root
                    g = pixel(bi, y0 + rs // TILE, x0 + rs % TILE)
                    labels[pixel(bi, y0 + r, x0 + c)] = g if root < tpx else g + n

    for block in range(grid):  # phase 2
        for t in p.tiles_of(block):
            bi, y0, x0 = p.tile(t)
            for side in range(3):
                prev = [NONE] * 4
                for lane in range(TILE):
                    r, c = (0, lane) if side == 0 else (lane, 0 if side == 1 else TILE - 1)
                    y, x = y0 + r, x0 + c
                    own, nb = NONE, [NONE] * 4
                    if (side == 0 or lane > 0) and y < h and x < w:
                        own = int(labels[pixel(bi, y, x)])
                    if own != NONE:
                        looks = ([(-1, -1), (-1, 0), (-1, 1)] + ([(0, -1)] if c == 0 else [])
                                 if side == 0 else [(0, -1), (-1, -1)] if side == 1
                                 else [(-1, 1)])
                        for k, (dy, dx) in enumerate(looks):
                            ny, nx = y + dy, x + dx
                            if ny >= 0 and 0 <= nx < w:
                                nb[k] = int(labels[pixel(bi, ny, nx)])
                    for k in range(1, 4):
                        if nb[k] in nb[:k]:
                            nb[k] = NONE
                    made = [v for v in nb if not (lane > 0 and v in prev)]
                    prev = list(nb)
                    for v in made:
                        if v != NONE:
                            unite(labels, n, own, v)

    edges = np.zeros(n, bool)  # phase 3
    for i in np.flatnonzero(labels != NONE):
        edges[i] = find(labels, n, int(labels[i])) < n
    return edges.reshape(b, h, w)


def canny(image: torch.Tensor, low_threshold=100.0, high_threshold=200.0) -> torch.Tensor:
    """cv2-exact Canny, plain. image: [H, W, 3] or [B, H, W, 3] in [0, 255].
    Returns uint8 edges in {0, 255}, [H, W] or [B, H, W]."""
    single = image.dim() == 3
    low, high = floor_thresholds(low_threshold, high_threshold)
    cls = classes_plain(image[None] if single else image, low, high)
    edges = hysteresis_plain(cls).to(torch.uint8) * 255
    return edges[0] if single else edges


# ----------------------------------------------------------------- wrappers


def _suffix(dtype: torch.dtype) -> str:
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the Canny kernels write bf16 or fp32, not {dtype}")
    return "f32" if dtype == torch.float32 else "bf16"


def _count(name: str, dtype: torch.dtype) -> None:
    launches[name + ("_f32" if dtype == torch.float32 else "")] += 1


def _launch(name: str, device: torch.device, *args) -> None:
    from fastedit_tpu_torch.ops.build import library

    fn = getattr(library("canny"), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _check_batch(t: torch.Tensor, what: str, dtype: torch.dtype, rank: int) -> None:
    if t.dim() != rank or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dtype} tensor of rank {rank}; got "
                         f"{t.dtype} {tuple(t.shape)}")
    if rank == 4 and t.shape[-1] != 3:
        raise ValueError(f"{what} must be [B, H, W, 3]; got {tuple(t.shape)}")
    if t.shape[0] * t.shape[1] * t.shape[2] >= 2**30:
        raise ValueError(f"{what}: {tuple(t.shape)} holds too many pixels for int32 node ids")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{what} must start on a 16-byte boundary (the kernel stages its rows "
                         "in 16-byte copies)")


def _device_threshold(t, device: torch.device) -> torch.Tensor:
    if not (isinstance(t, torch.Tensor) and t.dtype == torch.int32 and t.numel() == 1
            and t.device == device):
        raise ValueError(f"a Canny kernel takes its thresholds as int32 tensors on {device} "
                         "(threshold_tensors)")
    return t


_counters: dict[int, torch.Tensor] = {}


def _counter(device: torch.device) -> torch.Tensor:
    """The kernel's three counters (the grid-wide barriers' arrivals, the
    blocks out, the tiles handed out), zero between calls: the last block out
    sets them back.  One buffer per device, for calls on one stream at a
    time; made by the first call, which runs outside any graph capture."""
    index = _index(device)
    if index not in _counters:
        _counters[index] = torch.zeros(3, dtype=torch.int32, device=device)
    return _counters[index]


def prepare(image: torch.Tensor, low, high, dtype: torch.dtype):
    """uint8 [B, H, W, 3] -> (control [B, H, W, 3] in {0, 1}, VAE input
    ``f / 127.5 - 1`` [B, H, W, 3] in [-1, 1]), both in ``dtype``, bf16 or
    fp32.

    ``low <= high``, floored (:func:`threshold_tensors`).  A CPU tensor takes
    the plain version (thresholds as ints or tensors); a CUDA tensor launches
    the kernel once, with ``low`` and ``high`` as int32 tensors on its device
    (int32 labels of the batch's size allocated here), or raises."""
    sfx = _suffix(dtype)
    _check_batch(image, "prepare's image", torch.uint8, 4)
    if image.device.type == "cpu":
        return prepare_plain(image, low, high, dtype)
    low, high = (_device_threshold(t, image.device) for t in (low, high))
    b, h, w, _ = image.shape
    p = plan_for(image, dtype)
    labels = torch.empty((b, h, w), dtype=torch.int32, device=image.device)
    control = torch.empty((b, h, w, 3), dtype=dtype, device=image.device)
    vae_in = torch.empty((b, h, w, 3), dtype=dtype, device=image.device)
    _launch(f"canny_prepare_{sfx}", image.device, image.data_ptr(), low.data_ptr(),
            high.data_ptr(), labels.data_ptr(), _counter(image.device).data_ptr(),
            control.data_ptr(), vae_in.data_ptr(), b, h, w, p.grid)
    _count("canny_prepare", dtype)
    return control, vae_in


def canny_front(image: torch.Tensor, low, high, dtype: torch.dtype):
    """uint8 [B, H, W, 3] -> (class map uint8 [B, H, W], VAE input
    ``f / 127.5 - 1`` [B, H, W, 3] in ``dtype``, bf16 or fp32): the kernel's
    front alone, for the checks of the class map.

    Thresholds as for :func:`prepare`.  A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel's front entry or raises."""
    sfx = _suffix(dtype)
    _check_batch(image, "canny_front's image", torch.uint8, 4)
    if image.device.type == "cpu":
        return canny_front_plain(image, low, high, dtype)
    low, high = (_device_threshold(t, image.device) for t in (low, high))
    b, h, w, _ = image.shape
    cls = torch.empty((b, h, w), dtype=torch.uint8, device=image.device)
    vae_in = torch.empty((b, h, w, 3), dtype=dtype, device=image.device)
    _launch(f"canny_front_{sfx}", image.device, image.data_ptr(), low.data_ptr(),
            high.data_ptr(), _counter(image.device).data_ptr(), cls.data_ptr(),
            vae_in.data_ptr(), b, h, w, plan_for(image, dtype).grid)
    _count("canny_front", dtype)
    return cls, vae_in


def canny_hysteresis(cls: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Class map uint8 [B, H, W] -> control [B, H, W, 3] in {0, 1} in
    ``dtype``: 1 where a candidate is 8-connected to a strong pixel through
    candidates.  The kernel's hysteresis alone, on a class map it is given
    (the stress masks, the conformance tool).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel's hysteresis entry (int32 labels of the batch's size allocated
    here) or raises."""
    sfx = _suffix(dtype)
    _check_batch(cls, "canny_hysteresis's class map", torch.uint8, 3)
    if cls.device.type == "cpu":
        return canny_hysteresis_plain(cls, dtype)
    b, h, w = cls.shape
    labels = torch.empty((b, h, w), dtype=torch.int32, device=cls.device)
    control = torch.empty((b, h, w, 3), dtype=dtype, device=cls.device)
    _launch(f"canny_hysteresis_{sfx}", cls.device, cls.data_ptr(), labels.data_ptr(),
            _counter(cls.device).data_ptr(), control.data_ptr(), b, h, w,
            plan_for(cls, dtype).grid)
    _count("canny_hysteresis", dtype)
    return control


# --------------------------------------------------------- numpy reference


def canny_np(
    image: np.ndarray, low_threshold=100.0, high_threshold=200.0
) -> np.ndarray:
    """Same cv2-exact algorithm in plain numpy (BFS hysteresis)."""
    img = np.asarray(image)
    if img.ndim == 3:
        u = np.round(img).astype(np.int64) if np.issubdtype(
            img.dtype, np.floating
        ) else img.astype(np.int64)
        acc = (
            u[..., 0] * _GRAY_COEF[0]
            + u[..., 1] * _GRAY_COEF[1]
            + u[..., 2] * _GRAY_COEF[2]
            + (1 << (_GRAY_SHIFT - 1))
        )
        gray = (acc >> _GRAY_SHIFT).astype(np.int32)
    elif np.issubdtype(img.dtype, np.floating):
        gray = np.round(img).astype(np.int32)
    else:
        gray = img.astype(np.int32)
    low = int(np.floor(low_threshold))
    high = int(np.floor(high_threshold))
    if low > high:
        low, high = high, low

    g = np.pad(gray, 1, mode="edge")
    h, w = gray.shape

    def sh(dy, dx):
        return g[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    gx = (sh(-1, 1) - sh(-1, -1)) + 2 * (sh(0, 1) - sh(0, -1)) + (sh(1, 1) - sh(1, -1))
    gy = (sh(1, -1) - sh(-1, -1)) + 2 * (sh(1, 0) - sh(-1, 0)) + (sh(1, 1) - sh(-1, 1))
    mag = np.abs(gx) + np.abs(gy)

    ax = np.abs(gx)
    ay = np.abs(gy) << _CANNY_SHIFT
    tg22x = ax * _TG22
    tg67x = tg22x + ((2 * ax) << _CANNY_SHIFT)
    m = np.pad(mag, 1)

    def shm(dy, dx):
        return m[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    horiz = ay < tg22x
    vert = ay > tg67x
    s_neg = np.bitwise_xor(gx, gy) < 0
    keep_h = (mag > shm(0, -1)) & (mag >= shm(0, 1))
    keep_v = (mag > shm(-1, 0)) & (mag >= shm(1, 0))
    keep_d1 = (mag > shm(-1, -1)) & (mag > shm(1, 1))
    keep_d2 = (mag > shm(-1, 1)) & (mag > shm(1, -1))
    keep = np.where(
        horiz, keep_h, np.where(vert, keep_v, np.where(s_neg, keep_d2, keep_d1))
    )

    cand = keep & (mag > low)
    strong = cand & (mag > high)
    return (flood_fill_np(strong, cand) * 255).astype(np.uint8)


def flood_fill_np(strong: np.ndarray, cand: np.ndarray) -> np.ndarray:
    """The candidates 8-connected to a strong pixel through candidates
    (bool [H, W]), by a stack-based flood fill from the strong pixels."""
    h, w = cand.shape
    visited = strong.copy()
    stack = list(zip(*np.nonzero(strong)))
    while stack:
        y, x = stack.pop()
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ny, nx = y + dy, x + dx
                if 0 <= ny < h and 0 <= nx < w and cand[ny, nx] and not visited[ny, nx]:
                    visited[ny, nx] = True
                    stack.append((ny, nx))
    return visited
