"""Card-against-CPU numeric conformance, in one process.

The port's counterpart of the JAX package's ``tools/tpu_conformance.py``.
A CPU test cannot see numerics that only the card has: TF32 in an "fp32"
conv or matmul (cuDNN runs fp32 convs in TF32 by default, which cancels in
SSIM's sigma = E[x^2] - mu^2), or a kernel's own summation order.  This
tool runs the numerically sensitive functions on ``--device`` (default the
card) and on ``--host`` (default the CPU) and compares them, with the JAX
tool's inputs (one ``numpy`` generator, seed 0, drawn in its order) and
tolerances:

  * SSIM on a high-DC low-variance stress pair and on a structured pair
    (1e-4), PSNR (1e-3) and MSE (1e-7), from ``metrics/functional.py``
    inside ``utils/precision.true_fp32()``, as the metrics run;
  * Canny (``ops/canny.py``, on the card its kernel), bit for bit:
    device against host, and each against ``canny_np``, the numpy
    reference; a sweep of thresholds (floats, ``low > high``, none at all)
    on the device against ``canny_np``; and the hysteresis alone on the
    device against a flood fill (``canny.flood_fill_np``) on stress masks: a
    serpentine (one weak chain of every other row, turning through corners
    only, strong at one end), a zigzag whose every link is through a corner,
    and random candidates at densities 0.1 to 0.6;
  * attention at (1, 256, 2, 64), fp32 in (5e-3): the plain op on the device
    against the host (``flags.override(plain_versions=True)``), then the
    flash kernel (K2) on the device against the plain op on the host;
  * GroupNorm + SiLU at (1, 32, 32, 64), 32 groups (5e-3): the GroupNorm
    kernel (K7) on the device against the plain op on the host.

On the CPU a kernel's wrapper runs its plain version, so ``--device cpu``
compares the CPU with itself (the tests run it so).  The default device is
the card: without one this raises, and never reports a conformance it did
not check.

Usage:  python -m fastedit_tpu_torch.tools.conformance [--device cuda] [--host cpu]
It prints one line per check and exits 0 when every check holds, 1
otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from fastedit_tpu_torch.metrics import functional as F
from fastedit_tpu_torch.ops import flags
from fastedit_tpu_torch.ops.attention import attention
from fastedit_tpu_torch.ops import canny as canny_ops
from fastedit_tpu_torch.ops.canny import canny_np, flood_fill_np
from fastedit_tpu_torch.ops.groupnorm import group_norm, group_norm_plain
from fastedit_tpu_torch.utils.precision import true_fp32


@dataclasses.dataclass
class Result:
    name: str
    delta: float  # max |device - host|, or the number of values that differ
    tol: float
    exact: bool = False

    @property
    def ok(self) -> bool:
        return self.delta == 0 if self.exact else self.delta <= self.tol

    def line(self) -> str:
        return (f"[conformance] {self.name:38s} {'ok' if self.ok else 'FAIL'}  "
                f"(max delta {self.delta:.3e}, tol {self.tol:.0e}"
                f"{', exact' if self.exact else ''})")


def _on(device: torch.device, fn, *arrays) -> np.ndarray:
    """``fn`` on the arrays as tensors on ``device``; the result on the host."""
    out = fn(*(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out.detach().cpu().numpy()


def _compare(name: str, device, host, fn, args, tol: float) -> Result:
    a = _on(device, fn, *args).astype(np.float64)
    c = _on(host, fn, *args).astype(np.float64)
    return Result(name, float(np.max(np.abs(a - c))), tol)


def _exact(name: str, a: np.ndarray, b: np.ndarray) -> Result:
    return Result(name, float(np.sum(a != b)), 0.0, exact=True)


def inputs(seed: int = 0) -> dict:
    """The checks' inputs, drawn in the JAX tool's order."""
    rng = np.random.default_rng(seed)
    x = (0.8 + 0.01 * rng.standard_normal((1, 256, 256, 3))).astype(np.float32)
    y = (x + 0.005 * rng.standard_normal((1, 256, 256, 3))).astype(np.float32)
    g = np.clip(np.cumsum(rng.random((1, 256, 256, 3)), axis=1) / 256.0, 0, 1).astype(np.float32)
    img = rng.integers(0, 255, (128, 128, 3)).astype(np.float32)
    img[20:90, 30:70] = rng.integers(0, 255, 3)  # a block: long edges to grow along
    q = rng.standard_normal((1, 256, 2, 64)).astype(np.float32) * 0.1
    h = rng.standard_normal((1, 32, 32, 64)).astype(np.float32)
    return dict(x=x, y=y, g=g, img=img, q=q, h=h)


def metric_checks(device: torch.device, host: torch.device, inp: dict) -> list:
    """SSIM, PSNR and MSE, each inside ``true_fp32()`` on both sides."""
    x, y, g = inp["x"], inp["y"], inp["g"]
    with true_fp32():
        return [
            _compare("ssim (high-DC stress)", device, host, lambda a, b: F.ssim(a, b),
                     (x, y), 1e-4),
            _compare("psnr", device, host, lambda a, b: F.psnr(a, b), (x, y), 1e-3),
            _compare("mse", device, host, lambda a, b: F.mse(a, b), (x, y), 1e-7),
            _compare("ssim (structured)", device, host, lambda a, b: F.ssim(a, b),
                     (g, np.roll(g, 3, axis=2)), 1e-4),
        ]


def serpentine(h: int, w: int) -> np.ndarray:
    """bool [h, w]: one chain of every other row (x from 1 to w - 2), each
    row joined to the next through one pixel beside its end, which touches
    both rows at a corner only, at alternate ends."""
    m = np.zeros((h, w), bool)
    rows = range(0, h, 2)
    for k, y in enumerate(rows):
        m[y, 1:w - 1] = True
        if y + 2 < h:
            m[y + 1, w - 1 if k % 2 == 0 else 0] = True
    return m


def zigzag(h: int, w: int) -> np.ndarray:
    """bool [h, w]: one chain on the pixels with y + x even, so that no two of
    its pixels share an edge and every link is through a corner: zigzag rows
    four apart, each joined to the next at alternate ends."""
    m = np.zeros((h, w - w % 2), bool)
    w = m.shape[1]
    xs = np.arange(w)
    bands = list(range(0, h - 1, 4))
    for k, y in enumerate(bands):
        m[y + xs % 2, xs] = True
        if y + 5 < h:
            if k % 2 == 0:
                m[y + 2, w - 2] = m[y + 3, w - 1] = True
            else:
                m[y + 2, 0] = m[y + 3, 1] = True
    return m


def stress_classes(seed: int = 0, size: int = 128) -> list:
    """(name, class map uint8 [H, W]) for the hysteresis checks: the serpentine
    and the zigzag, weak but for one strong end, and random candidates at
    densities 0.1 to 0.6 with one in fifty strong."""
    rng = np.random.default_rng(seed)
    out = []
    for name, chain in (("serpentine", serpentine(size, size)), ("zigzag", zigzag(size, size))):
        cls = chain.astype(np.uint8) * canny_ops.WEAK
        y, x = np.argwhere(chain)[0]
        cls[y, x] = canny_ops.STRONG
        out.append((name, cls))
    for density in (0.1, 0.2, 0.3, 0.4, 0.5, 0.6):
        cand = rng.random((size, size)) < density
        strong = cand & (rng.random((size, size)) < 0.02)
        out.append((f"random {density}", cand.astype(np.uint8) + strong.astype(np.uint8)))
    return out


def canny_edges(image: torch.Tensor, low, high) -> torch.Tensor:
    """uint8 edges [H, W] in {0, 255} of an [H, W, 3] image with integer
    values, through prepare's Canny (``ops/canny.prepare``: the kernels on
    the card, the plain version on the CPU)."""
    lo, hi = canny_ops.threshold_tensors(low, high, image.device)
    control, _ = canny_ops.prepare(image.round().to(torch.uint8)[None], lo, hi, torch.float32)
    return (control[0, ..., 0] > 0).to(torch.uint8) * 255


def hysteresis(cls: torch.Tensor) -> torch.Tensor:
    """bool edges [H, W] of a class map [H, W] (uint8), through prepare's
    hysteresis (``ops/canny.canny_hysteresis``)."""
    return canny_ops.canny_hysteresis(cls[None], torch.float32)[0, ..., 0] > 0


# Threshold pairs of the sweep: the default, swapped, floats, none at all,
# above every magnitude, and equal thresholds.
THRESHOLD_SWEEP = ((100, 200), (200, 100), (50.7, 120.2), (0, 0), (20, 40), (150, 150),
                   (300, 3000))


def canny_checks(device: torch.device, host: torch.device, inp: dict) -> list:
    img = inp["img"]
    on_device = _on(device, lambda t: canny_edges(t, 100, 200), img)
    on_host = _on(host, lambda t: canny_edges(t, 100, 200), img)
    ref = canny_np(img, 100, 200)
    sweep = sum(int(np.sum(_on(device, lambda t: canny_edges(t, lo, hi), img)
                           != canny_np(img, lo, hi))) for lo, hi in THRESHOLD_SWEEP)
    chains, random_masks = 0, 0
    for name, cls in stress_classes():
        want = flood_fill_np(cls == canny_ops.STRONG, cls != 0)
        wrong = int(np.sum(_on(device, hysteresis, cls) != want))
        if name.startswith("random"):
            random_masks += wrong
        else:
            chains += wrong
    return [_exact("canny (device vs host)", on_device, on_host),
            _exact("canny (device vs numpy reference)", on_device, ref),
            _exact("canny (host vs numpy reference)", on_host, ref),
            Result("canny thresholds (device vs numpy)", float(sweep), 0.0, exact=True),
            Result("hysteresis chains (device vs fill)", float(chains), 0.0, exact=True),
            Result("hysteresis random (device vs fill)", float(random_masks), 0.0,
                   exact=True)]


def op_checks(device: torch.device, host: torch.device, inp: dict) -> list:
    """Attention and GroupNorm: agreement scale only (the kernels are built
    for bf16 and fp32 inputs and sum in their own order)."""
    q, h = inp["q"], inp["h"]

    def attn(a, b, c):
        return attention(a, b, c)

    with flags.override(plain_versions=True):
        plain = _compare("attention (plain op, fp32 in)", device, host, attn, (q, q, q), 5e-3)
        attn_host = _on(host, attn, q, q, q).astype(np.float64)
    attn_dev = _on(device, attn, q, q, q).astype(np.float64)
    flash = Result("flash attention (kernel vs plain)",
                   float(np.max(np.abs(attn_dev - attn_host))), 5e-3)
    sc, bi = np.ones((64,), np.float32), np.zeros((64,), np.float32)
    gn_dev = _on(device, lambda t, s, b: group_norm(t, s, b, 32, act="silu"), h, sc, bi)
    gn_host = _on(host, lambda t, s, b: group_norm_plain(t, s, b, 32, act="silu"), h, sc, bi)
    gn = Result("group_norm+silu (kernel vs plain)",
                float(np.max(np.abs(gn_dev.astype(np.float64) - gn_host))), 5e-3)
    return [plain, flash, gn]


def run(device: torch.device, host: torch.device) -> list:
    """Every check, in the JAX tool's order."""
    inp = inputs()
    return (metric_checks(device, host, inp) + canny_checks(device, host, inp)
            + op_checks(device, host, inp))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Card-against-CPU numeric conformance.")
    p.add_argument("--device", default="cuda", help="the device under test (default: the card)")
    p.add_argument("--host", default="cpu", help="the reference device (default: the CPU)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device, host = torch.device(args.device), torch.device(args.host)
    for d in (device, host):
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"conformance on {d} asked for, but CUDA is not available; "
                               "pass --device cpu to compare the CPU with itself")
    print(f"[conformance] device={device} host={host}")
    results = run(device, host)
    for r in results:
        print(r.line())
    failures = [r.name for r in results if not r.ok]
    if failures:
        print(f"[conformance] FAILED: {failures}")
        return 1
    print("[conformance] all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
