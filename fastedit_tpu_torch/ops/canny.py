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
computes Canny in XLA inside its edit program) is two kernel wrappers over
``csrc/canny.cu``, with no host synchronisation and a fixed number of
launches, so the editor captures it as the first graph of an edit's chain
(``pipeline/graphs.py``):

* :func:`canny_front`: one stencil pass per tile: gray, Sobel, magnitude,
  NMS and the double threshold into a class map (0, :data:`WEAK`,
  :data:`STRONG`), and in the same pass the VAE input ``f / 127.5 - 1`` in
  the model dtype.  The thresholds are int32 device tensors, already floored
  and ordered (:func:`threshold_tensors`), so one graph serves every
  threshold;
* :func:`canny_hysteresis`: connected-component labelling by union-find
  over the candidates (a tile-local merge in shared memory, a merge across
  tile borders, a write pass that finds each candidate's root), three
  launches whatever the length of an edge chain; writes the control image
  ``[B, H, W, 3]`` in {0, 1} in the model dtype.

:func:`prepare` is both.  The plain versions (:func:`prepare_plain`,
:func:`canny_front_plain`, :func:`canny_hysteresis_plain`, and :func:`canny`,
the edges as uint8) are for a CPU tensor and for comparisons
(``flags.override(plain_versions=True)``); like the kernels they take ordered
thresholds, but :func:`canny`, which floors and orders its own.  Their
hysteresis grows the strong
pixels by masked dilation and reads on the host, every 8 dilations, whether
it has reached its fixed point.  :func:`canny_np` is the same algorithm in
plain numpy with a stack-based flood fill for the hysteresis, the port's own
copy of the JAX package's reference (``tools/conformance.py`` holds the card
to it bit for bit).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_GRAY_COEF = (9798, 19235, 3735)
_GRAY_SHIFT = 15
_CANNY_SHIFT = 15
_TG22 = 13573
WEAK, STRONG = 1, 2  # the class map's values (0: not a candidate)

# Launches since the last reset (chip_smoke.py resets them), by kernel and
# by the outputs' dtype: <name> in bf16, <name>_f32 in fp32.
launches = {"canny_front": 0, "canny_front_f32": 0,
            "canny_hysteresis": 0, "canny_hysteresis_f32": 0}


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


def _device_threshold(t, device: torch.device) -> torch.Tensor:
    if not (isinstance(t, torch.Tensor) and t.dtype == torch.int32 and t.numel() == 1
            and t.device == device):
        raise ValueError(f"a Canny kernel takes its thresholds as int32 tensors on {device} "
                         "(threshold_tensors)")
    return t


def canny_front(image: torch.Tensor, low, high, dtype: torch.dtype):
    """uint8 [B, H, W, 3] -> (class map uint8 [B, H, W], VAE input
    ``f / 127.5 - 1`` [B, H, W, 3] in ``dtype``, bf16 or fp32).

    ``low <= high``, floored (:func:`threshold_tensors`).  A CPU tensor takes
    the plain version (thresholds as ints or tensors); a CUDA tensor launches
    the kernel, with ``low`` and ``high`` as int32 tensors on its device, or
    raises."""
    sfx = _suffix(dtype)
    _check_batch(image, "canny_front's image", torch.uint8, 4)
    if image.device.type == "cpu":
        return canny_front_plain(image, low, high, dtype)
    low, high = (_device_threshold(t, image.device) for t in (low, high))
    b, h, w, _ = image.shape
    cls = torch.empty((b, h, w), dtype=torch.uint8, device=image.device)
    vae_in = torch.empty((b, h, w, 3), dtype=dtype, device=image.device)
    _launch(f"canny_front_{sfx}", image.device, image.data_ptr(), low.data_ptr(),
            high.data_ptr(), cls.data_ptr(), vae_in.data_ptr(), b, h, w)
    _count("canny_front", dtype)
    return cls, vae_in


def canny_hysteresis(cls: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Class map uint8 [B, H, W] -> control [B, H, W, 3] in {0, 1} in
    ``dtype``: 1 where a candidate is 8-connected to a strong pixel through
    candidates.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernels (three launches, union-find over int32 labels of the batch's
    size, allocated here) or raises."""
    sfx = _suffix(dtype)
    _check_batch(cls, "canny_hysteresis's class map", torch.uint8, 3)
    if cls.device.type == "cpu":
        return canny_hysteresis_plain(cls, dtype)
    b, h, w = cls.shape
    labels = torch.empty((b, h, w), dtype=torch.int32, device=cls.device)
    control = torch.empty((b, h, w, 3), dtype=dtype, device=cls.device)
    for name in ("ccl_local", "ccl_border"):
        _launch(name, cls.device, cls.data_ptr(), labels.data_ptr(), b, h, w)
    _launch(f"ccl_write_{sfx}", cls.device, cls.data_ptr(), labels.data_ptr(),
            control.data_ptr(), b, h, w)
    _count("canny_hysteresis", dtype)
    return control


def prepare(image: torch.Tensor, low, high, dtype: torch.dtype):
    """uint8 [B, H, W, 3] -> (control [B, H, W, 3] in {0, 1}, VAE input
    [B, H, W, 3] in [-1, 1]), both in ``dtype``: :func:`canny_front`, then
    :func:`canny_hysteresis`."""
    cls, vae_in = canny_front(image, low, high, dtype)
    return canny_hysteresis(cls, dtype), vae_in


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
