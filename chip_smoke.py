#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fastedit_tpu_torch``) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` (on PATH or under /usr/local/cuda) and
``nvidia-smi``; it imports neither JAX nor the JAX package.  Phases, in
order; a failed phase raises and the script exits non-zero:

1. Build the CUDA kernels of ``fastedit_tpu_torch/csrc/`` (one ``nvcc`` per
   source, all started together) and print the card's name and power limit.
2. Hold every kernel against its plain PyTorch version at every distinct
   shape the SSD-1B edit path at 1024² gives it (shapes from the model
   configs, ``tools/inventory.py``), on seeded random bf16 inputs, and time
   the kernel, the plain version and one PyTorch library call for the same
   function with CUDA events.  Each attention shape also reads a planted
   fault (the last KV tile skipped), which the tolerance must reject.
3. The main path: ``FastEditor("ssd-1b", random_weights=True)`` at 1024²,
   a warm-up, three ``edit()`` calls and one ``edit_batch`` of two images.
   Seconds per edit and per stage, peak memory, and each kernel's launches,
   which must equal the counts derived from the configs.
4. Kernels against plain versions end to end: the same editor with seeded
   fan-in-scaled weights, one edit with the kernels and one with
   ``flags.override`` selecting the plain versions; final latents and
   images compared.  Two plain edits with a planted fault (attention, conv)
   are read against the plain edit beside the limits.

It prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``.  Per-shape kernel figures and the main-path timings are also
written to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_FILE = ROOT / "chiprun_out" / "chip_smoke.json"

# Published H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core rate
# and HBM3 bandwidth.  A bound is the larger of operations / peak rate and
# bytes / bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

RESOLUTION = 1024
EDIT_KW = dict(strength=0.8, num_inference_steps=4, guidance_scale=1.5)
TIMING_REPS = 10

# Kernel vs plain version, per element, in bf16.  Both accumulate in fp32
# and round once to bf16, so they differ by the final rounding (one bf16
# ulp, at most 2^-7 of the value) plus fp32 summation-order differences,
# which matter only for outputs near zero: the absolute term.
CONV_REL, CONV_ABS_OF_MAX = 2.0**-7, 2.0**-10
# Attention: the same relative term; the absolute term scales with the
# RMS of the output, which shrinks as 1/sqrt(Skv) for a flat softmax.  It
# lies between the worst reading of the kernel and that of a planted fault
# (the plain version with the kernel's last KV tile skipped), both read on
# the card in every run (phase 2).
ATTN_REL, ATTN_ABS_OF_RMS = 2.0**-7, 2.0**-3
KV_TILE = {64: 64, 512: 32}  # keys per KV tile in csrc/flash_attention.cu
# End to end (phase 4): the paths agree per op within the bounds above, and
# bf16 rounding differences (2^-9 relative) at some 200 sequential layers
# per step over 3 steps leave a few percent at most in the final latents.
# Planted faults are read in the same run, against the plain edit: a conv
# kernel that skips its last Cin step must fail these limits.  A skipped
# attention KV tile moves the latents no more than bf16 rounding does, so
# it is recorded only; phase 2 catches it.
E2E_LATENT_REL_L2 = 5e-2
E2E_IMAGE_MEAN_LSB = 4.0


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = TIMING_REPS) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back calls
    (after one warm-up call), from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_close(what: str, out, ref, rel: float, abs_tol: float) -> tuple[float, float]:
    """Raise unless |out - ref| <= rel * |ref| + abs_tol everywhere; return
    (max abs error, max abs error / max |ref|)."""
    d = (out.float() - ref.float()).abs()
    lim = rel * ref.float().abs() + abs_tol
    n_bad = int((d > lim).sum())
    err, scale = float(d.max()), float(ref.float().abs().max())
    if n_bad or not bool(out.float().isfinite().all()):
        raise AssertionError(
            f"{what}: {n_bad} elements outside tolerance (max abs err {err}, "
            f"max |ref| {scale})"
        )
    return err, err / max(scale, 1e-30)


def err_over_rms(out, ref, rel: float) -> float:
    """The least c for which |out - ref| <= rel * |ref| + c * rms(ref)
    holds everywhere."""
    d = (out.float() - ref.float()).abs() - rel * ref.float().abs()
    return float(d.max().clamp(min=0.0)) / float(ref.float().square().mean().sqrt())


# ------------------------------------------------------------------ phase 2


def kernel_shapes():
    """Per-edit call counts of the SSD-1B edit path at 1024² (one ``edit``
    and one ``edit_batch`` of two), from the configs."""
    from fastedit_tpu_torch.models import configs as C
    from fastedit_tpu_torch.tools import inventory

    args = (C.SSD1B_UNET, C.SDXL_CONTROLNET_SMALL, C.SDXL_VAE, RESOLUTION)
    return {b: inventory.edit_calls(*args, batch=b, steps=3) for b in (1, 2)}


def compare_conv(shapes: dict, gen) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from fastedit_tpu_torch.ops import conv3x3 as k

    rows = []
    keys = sorted({s for b in shapes for s in shapes[b][0]})
    for n, h, w, cin, cout in keys:
        if not k.supports((n, h, w, cin), (cout, cin, 3, 3)):
            continue
        dev = "cuda"
        x = torch.randn((n, h, w, cin), generator=gen, device=dev).bfloat16()
        wt = (torch.randn((cout, cin, 3, 3), generator=gen, device=dev) * (9 * cin) ** -0.5)
        wt = wt.bfloat16().contiguous(memory_format=torch.channels_last)
        bias = torch.randn(cout, generator=gen, device=dev) * 0.1
        out = k.conv3x3(x, wt, bias)
        ref = k.conv3x3_plain(x, wt, bias)
        torch.cuda.synchronize()
        err, rel = check_close(
            f"conv3x3 {(n, h, w, cin, cout)}", out, ref, CONV_REL,
            CONV_ABS_OF_MAX * float(ref.float().abs().max()),
        )
        del ref, out
        x_nchw, bias_bf = x.permute(0, 3, 1, 2), bias.bfloat16()
        flops = 2.0 * n * h * w * cout * 9 * cin
        nbytes = 2.0 * (n * h * w * cin + 9 * cin * cout + n * h * w * cout) + 4.0 * cout
        b_ms, b_by = bound_ms(flops, nbytes)
        rows.append(dict(
            kernel="conv3x3", shape=[n, h, w, cin, cout],
            calls_edit=shapes[1][0].get((n, h, w, cin, cout), 0),
            calls_edit_batch2=shapes[2][0].get((n, h, w, cin, cout), 0),
            max_abs_err=err, max_rel_err=rel,
            ms=time_ms(lambda: k.conv3x3(x, wt, bias)),
            plain_ms=time_ms(lambda: k.conv3x3_plain(x, wt, bias)),
            library_ms=time_ms(lambda: F.conv2d(x_nchw, wt, bias_bf, padding=1)),
            bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
        ))
        log("conv3x3", rows[-1]["shape"], {key: rows[-1][key] for key in
            ("max_abs_err", "max_rel_err", "ms", "plain_ms", "library_ms", "bound_ms")})
    return rows


def compare_attention(shapes: dict, gen) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from fastedit_tpu_torch.ops import flash_attention as fa

    rows, weak = [], []
    keys = sorted({s for b in shapes for s in shapes[b][1]})
    for b, sq, skv, h, d in keys:
        if not fa.supports((b, sq, h, d), skv):
            continue
        q = torch.randn((b, sq, h, d), generator=gen, device="cuda").bfloat16()
        kk = torch.randn((b, skv, h, d), generator=gen, device="cuda").bfloat16()
        v = torch.randn((b, skv, h, d), generator=gen, device="cuda").bfloat16()
        out = fa.flash_attention(q, kk, v)
        ref = fa.attention_plain(q, kk, v)
        tile = KV_TILE[d]
        faulty = fa.attention_plain(q, kk[:, :-tile], v[:, :-tile])
        torch.cuda.synchronize()
        sound_c, fault_c = err_over_rms(out, ref, ATTN_REL), err_over_rms(faulty, ref, ATTN_REL)
        log("attention", [b, sq, skv, h, d], f"err/rms kernel {sound_c:.5f}, "
            f"last KV tile skipped {fault_c:.5f}, limit {ATTN_ABS_OF_RMS}")
        if fault_c <= ATTN_ABS_OF_RMS:
            weak.append(f"flash_attention {(b, sq, skv, h, d)}: the tolerance passes "
                        f"a skipped KV tile ({fault_c} <= {ATTN_ABS_OF_RMS})")
        err, rel = check_close(
            f"flash_attention {(b, sq, skv, h, d)}", out, ref, ATTN_REL,
            ATTN_ABS_OF_RMS * float(ref.float().square().mean().sqrt()),
        )
        del ref, out, faulty
        qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, v))
        flops = 4.0 * b * h * sq * skv * d
        nbytes = 2.0 * b * h * d * (2 * sq + 2 * skv)
        b_ms, b_by = bound_ms(flops, nbytes)
        rows.append(dict(
            kernel=f"flash_attention_d{d}", shape=[b, sq, skv, h, d],
            calls_edit=shapes[1][1].get((b, sq, skv, h, d), 0),
            calls_edit_batch2=shapes[2][1].get((b, sq, skv, h, d), 0),
            max_abs_err=err, max_rel_err=rel, err_over_rms=sound_c,
            fault_err_over_rms=fault_c,
            ms=time_ms(lambda: fa.flash_attention(q, kk, v)),
            plain_ms=time_ms(lambda: fa.attention_plain(q, kk, v)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
        ))
        log("attention", rows[-1]["shape"], {key: rows[-1][key] for key in
            ("max_abs_err", "max_rel_err", "ms", "plain_ms", "library_ms", "bound_ms")})
    if weak:
        raise AssertionError("\n".join(weak))
    return rows


# ------------------------------------------------------------------ phase 3


def test_image(seed: int, n: int = RESOLUTION):
    """A seeded RGB scene with gradients, blocks and noise (Canny finds
    edges in it at the default thresholds)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:n, :n]
    img = np.stack([xx * 255 // n, yy * 255 // n, (xx + yy) * 255 // (2 * n)], -1)
    img = img + rng.integers(-12, 13, img.shape)
    for _ in range(16):
        y0, x0 = rng.integers(0, n - n // 8, 2)
        dy, dx = rng.integers(n // 32, n // 8, 2)
        img[y0:y0 + dy, x0:x0 + dx] = rng.integers(0, 256, 3)
    return Image.fromarray(np.clip(img, 0, 255).astype(np.uint8), "RGB")


class StageTimer:
    """Wraps the pipeline's stage functions with CUDA events, so each
    edit's device time per stage can be read after it returns."""

    STAGES = ("encode_prompt", "prepare", "vae_sample", "denoise", "vae_decode")

    def __init__(self):
        from fastedit_tpu_torch.pipeline import stages

        self.stages = stages
        self.events = []
        self.last_latents = None
        self._orig = {name: getattr(stages, name) for name in self.STAGES}
        for name, fn in self._orig.items():
            setattr(stages, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        import torch

        def timed(*args, **kwargs):
            if name == "vae_decode":
                self.last_latents = args[1].float().clone()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events.append((name, start, end))
            return out

        return timed

    def take(self) -> dict:
        """Device ms per stage since the last call (the edit has returned,
        so its events have completed)."""
        ms = {}
        for name, start, end in self.events:
            end.synchronize()
            ms[name] = ms.get(name, 0.0) + start.elapsed_time(end)
        self.events = []
        return ms

    def remove(self):
        for name, fn in self._orig.items():
            setattr(self.stages, name, fn)


def launch_counts() -> dict:
    from fastedit_tpu_torch.ops import conv3x3, flash_attention

    return {"conv3x3": conv3x3.launches,
            **{f"flash_attention_d{d}": n for d, n in flash_attention.launches.items()}}


def reset_launch_counts() -> None:
    from fastedit_tpu_torch.ops import conv3x3, flash_attention

    conv3x3.launches = 0
    for d in flash_attention.launches:
        flash_attention.launches[d] = 0


def expected_launches(conv_calls, attn_calls) -> dict:
    """Kernel launches the configs predict for the given call Counters."""
    from fastedit_tpu_torch.ops import conv3x3, flash_attention

    exp = {"conv3x3": sum(
        c for (n, h, w, cin, cout), c in conv_calls.items()
        if conv3x3.supports((n, h, w, cin), (cout, cin, 3, 3)))}
    for d in flash_attention.HEAD_DIMS:
        exp[f"flash_attention_d{d}"] = sum(
            c for (b, sq, skv, h, dd), c in attn_calls.items()
            if dd == d and flash_attention.supports((b, sq, h, dd), skv))
    return exp


def check_image(img) -> None:
    import numpy as np

    arr = np.asarray(img)
    if arr.dtype != np.uint8 or arr.shape != (RESOLUTION, RESOLUTION, 3):
        raise AssertionError(f"edit returned {arr.dtype} {arr.shape}")


def main_path(shapes: dict):
    import torch

    from fastedit_tpu_torch import FastEditor

    t0 = time.perf_counter()
    editor = FastEditor("ssd-1b", random_weights=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    warm_s = editor.warmup(**EDIT_KW)
    log(f"editor built in {build_s:.2f} s, warm-up edit {warm_s:.2f} s")

    timer = StageTimer()
    images = [test_image(1), test_image(2)]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    edits = []
    for i in range(3):
        t = time.perf_counter()
        out = editor.edit(images[0], "a watercolor painting of a harbor", seed=i, **EDIT_KW)
        edits.append(dict(seconds=time.perf_counter() - t, stage_ms=timer.take()))
        check_image(out)
        log(f"edit {i}: {edits[-1]['seconds']:.4f} s", edits[-1]["stage_ms"])
    t = time.perf_counter()
    outs = editor.edit_batch(images, ["a snowy street", "a city at night"], seed=3, **EDIT_KW)
    batch = dict(seconds=time.perf_counter() - t, stage_ms=timer.take())
    for out in outs:
        check_image(out)
    log(f"edit_batch of 2: {batch['seconds']:.4f} s", batch["stage_ms"])
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 1024**3

    per_edit = expected_launches(*shapes[1])
    per_batch2 = expected_launches(*shapes[2])
    expected = {k: 3 * per_edit[k] + per_batch2[k] for k in per_edit}
    log("launches (3 edits + a batch of 2):", launches, "expected:", expected,
        "per edit:", per_edit)
    for name, n in launches.items():
        if n <= 0 or n != expected[name]:
            raise AssertionError(f"{name}: {n} launches, expected {expected[name]}")
    log(f"peak device memory {peak_gib:.3f} GiB")
    return editor, timer, dict(
        editor_build_s=build_s, warmup_s=warm_s, edits=edits, edit_batch2=batch,
        launches=launches, launches_per_edit=per_edit, peak_gib=peak_gib,
    )


# ------------------------------------------------------------------ phase 4


def seeded_weights_(editor, seed: int) -> None:
    """Seeded fan-in-scaled normal weights on the card, zero biases,
    identity norms, as the tiny model is initialised (the zero weights of
    ``random_weights`` prove nothing about values)."""
    import torch

    from fastedit_tpu_torch.pipeline.editor import _seeded_init_

    gen = torch.Generator(device="cuda").manual_seed(seed)
    mod = editor.modules
    for model in (mod.unet, mod.controlnet, mod.vae, mod.text_encoder, mod.text_encoder_2):
        _seeded_init_(model, gen)
    editor.clear_memory()  # cached prompt embeddings came from the old weights


@contextlib.contextmanager
def planted_fault(kind: str):
    """Plant a kernel-sized fault in the plain versions, inside the kernel's
    gate: ``attention`` skips the last KV tile, as a kernel whose loop stops
    one tile short; ``conv`` skips the last Cin step (64 channels) of the
    last tap, as a kernel whose K loop stops one step short."""
    from fastedit_tpu_torch.ops import conv3x3, flash_attention

    if kind == "attention":
        # the module, not the function that ``ops/__init__.py`` exports
        module, name = sys.modules["fastedit_tpu_torch.ops.attention"], "attention_plain"
        orig = module.attention_plain

        def faulty(q, k, v, scale=None):
            if flash_attention.supports(tuple(q.shape), k.shape[1]):
                tile = KV_TILE[q.shape[-1]]
                k, v = k[:, :-tile], v[:, :-tile]
            return orig(q, k, v, scale)
    else:
        module, name = conv3x3, "conv3x3_plain"
        orig = conv3x3.conv3x3_plain

        def faulty(x, weight, bias=None, act=None):
            w = weight.clone()
            w[:, (w.shape[1] - 1) // 64 * 64:, 2, 2] = 0
            return orig(x, w, bias, act)
    setattr(module, name, faulty)
    try:
        yield
    finally:
        setattr(module, name, orig)


def kernels_vs_plain(editor, timer) -> dict:
    import numpy as np
    import torch

    from fastedit_tpu_torch.ops import flags

    seeded_weights_(editor, seed=20261016)
    img, prompt = test_image(5), "an oil painting of a lighthouse"
    editor.edit(img, prompt, seed=11, **EDIT_KW)  # encodes the prompt
    timer.take()

    def run(fault=None, **override):
        with flags.override(**override), (planted_fault(fault) if fault
                                          else contextlib.nullcontext()):
            t = time.perf_counter()
            out = np.asarray(editor.edit(img, prompt, seed=11, **EDIT_KW), np.int32)
            sec = time.perf_counter() - t
        timer.take()
        if not bool(timer.last_latents.isfinite().all()):
            raise AssertionError("non-finite final latents")
        return out, timer.last_latents, sec

    def differ(a, b) -> dict:
        diff = np.abs(a[0] - b[0])
        return dict(latent_rel_l2=float((a[1] - b[1]).norm() / b[1].norm()),
                    image_mean_abs_lsb=float(diff.mean()), image_max_abs_lsb=int(diff.max()))

    kern = run()
    before = launch_counts()
    plain = run(use_cuda_conv=False, use_cuda_attention=False)
    faults = {kind: differ(run(kind, use_cuda_conv=False, use_cuda_attention=False), plain)
              for kind in ("attention", "conv")}
    if launch_counts() != before:
        raise AssertionError("a plain-version edit launched a kernel")
    res = dict(
        differ(kern, plain), image_std=float(plain[0].std()),
        latent_std=float(plain[1].std()), seconds_kernels=kern[2], seconds_plain=plain[2],
        planted_faults=faults,
    )
    log("kernels vs plain end to end:", res)
    if (res["latent_rel_l2"] > E2E_LATENT_REL_L2
            or res["image_mean_abs_lsb"] > E2E_IMAGE_MEAN_LSB):
        raise AssertionError(
            f"kernel edit differs from plain edit beyond tolerance "
            f"(latents rel L2 <= {E2E_LATENT_REL_L2}, image mean <= "
            f"{E2E_IMAGE_MEAN_LSB} LSB): {res}"
        )
    if res["latent_std"] == 0.0:
        raise AssertionError("seeded-weight edit gave constant latents")
    conv_fault = faults["conv"]
    if (conv_fault["latent_rel_l2"] <= E2E_LATENT_REL_L2
            or conv_fault["image_mean_abs_lsb"] <= E2E_IMAGE_MEAN_LSB):
        raise AssertionError(f"the end-to-end tolerance passes a planted conv fault: {conv_fault}")
    torch.cuda.synchronize()
    return res


# --------------------------------------------------------------------- main


KERNELS = {
    "conv3x3": ("fastedit_tpu_torch/csrc/conv3x3.cu", "fastedit_tpu/ops/conv3x3.py:169"),
    "flash_attention_d64": ("fastedit_tpu_torch/csrc/flash_attention.cu",
                            "fastedit_tpu/ops/flash_attention.py:253"),
    "flash_attention_d512": ("fastedit_tpu_torch/csrc/flash_attention.cu",
                             "fastedit_tpu/ops/flash_attention.py:97"),
}


def kernel_summary(rows: list, launches: dict) -> list:
    """One entry per kernel.  Times and bounds are for one edit's calls of
    that kernel: the sum over its shapes of calls per edit x per-call time."""
    out = []
    for name, (source, replaces) in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        if not mine:
            raise AssertionError(f"no main-path shape reached {name}")

        def per_edit(key, mine=mine):
            return sum(r["calls_edit"] * r[key] for r in mine)

        ops_ms = 1e3 * per_edit("flops") / PEAK_BF16_FLOPS
        bytes_ms = 1e3 * per_edit("bytes") / PEAK_HBM_BYTES_PER_S
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=per_edit("ms"), plain_ms=per_edit("plain_ms"), bound_ms=per_edit("bound_ms"),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            library_ms=per_edit("library_ms"),
        ))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on a card",
              file=sys.stderr)
        return 2
    if not (ROOT / "fastedit_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no fastedit_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions are fp32 references
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    from fastedit_tpu_torch.ops import build

    card = card_line()
    log(card)
    log("torch", torch.__version__, "cuda", torch.version.cuda, torch.cuda.get_device_name(0))
    t = time.perf_counter()
    nvcc_logs = build.build_all()
    log(f"[1] kernels built in {time.perf_counter() - t:.2f} s")
    for name, text in nvcc_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {name}: {line.strip()}")

    log("[2] kernels vs plain versions at the main path's shapes")
    shapes = kernel_shapes()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = compare_conv(shapes, gen) + compare_attention(shapes, gen)
    torch.cuda.empty_cache()

    log("[3] main path: FastEditor('ssd-1b', random_weights=True) at 1024²")
    editor, timer, main = main_path(shapes)

    log("[4] kernels vs plain versions end to end, seeded weights")
    e2e = kernels_vs_plain(editor, timer)
    timer.remove()

    kernels = kernel_summary(rows, main["launches"])
    OUT_FILE.parent.mkdir(parents=True, exist_ok=True)
    OUT_FILE.write_text(json.dumps(dict(
        card=card, torch=torch.__version__, cuda=torch.version.cuda, kernels=kernels,
        shapes=rows, main_path=main, kernels_vs_plain=e2e,
        seconds_total=time.perf_counter() - t_start,
    ), indent=1))
    log(f"total {time.perf_counter() - t_start:.1f} s; details in {OUT_FILE.relative_to(ROOT)}")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
