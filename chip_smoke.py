#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``fastedit_tpu_torch``) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` (on PATH or under /usr/local/cuda) and
``nvidia-smi``; it imports neither JAX nor the JAX package.  With ``--only
group_norm`` (or ``conv``, ``fused``, ``up2``, ``down2``, ``attention``,
``canny``, ``layer_norm``, ``cross_attention``; several may be named) it builds
the kernels and runs those rows of phase 2 alone, bf16 and fp32, into
``chiprun_out/chip_smoke_only.json``, and
prints no result line; ``--only tensor_parallel`` runs phase 11's two bf16
arms there, on a new editor with phase 4's seeded weights.  Phases, in
order; a failed phase raises and the script exits non-zero:

1. Build the CUDA kernels of ``fastedit_tpu_torch/csrc/`` (one ``nvcc`` per
   source, all started together) and print the card's name and power limit.
2. Hold every kernel against its plain PyTorch version at every distinct
   shape the SSD-1B edit path at 1024² gives it under the kernel plan
   (shapes and counts from the model configs, ``tools/inventory.py``), on
   seeded random bf16 inputs, and time
   the kernel, the plain version and the nearest PyTorch library call with
   CUDA events: the kernel and the library call from a CUDA graph of 20 calls
   (``ms``, ``library_ms``: the device alone) and eagerly (``eager_ms``: 10
   back-to-back calls, which read the host where a call takes the device
   less than the host takes to enqueue it), the plain version eagerly.
   Each kernel also reads a planted fault in its plain version (attention:
   the last KV tile of the kernel's plan skipped; fused conv: the padding
   ring not re-zeroed; both stride-1 convs and up2 at batch 2: the halo row
   above an image read from the neighbouring image, as a tile that straddles
   two images would; up2: one phase's tap rows swapped; down2: the other
   padding;
   GroupNorm and its statistics alone: a one-pass variance on an input with
   |mean| >> std, and where the plan takes clusters the kernel built from
   a copy of ``csrc/group_norm.cu`` whose clusters leave a block out of
   their merge; LayerNorm: the same one-pass variance), which the tolerance
   must reject; every GroupNorm, statistics and LayerNorm call must run one
   device kernel (the profiler counts them).  LayerNorm's rows add the
   benchmark sweep's batch of four and the CLIP towers' shapes, and the share
   of 3.35 TB/s each reaches.  The cross-attention kernel (bf16 only) at the
   UNet's cross shapes, an edit's, a batch of two's and the sweep's batch of
   four, SSD-1B's and SDXL's calls beside each: one device kernel a call, at
   most 1% of the elements differing from the plain version, the padded keys
   left unmasked and P rounded before its sum as planted faults, SDPA as the
   yardstick and the share of 3.35 TB/s.  The rows of the convs, attention and
   GroupNorm also carry their plan (tiles, grid, shared memory), and the host's microseconds per
   launch of the stride-1 conv, the stride-2 conv and attention are printed.
   Then the same in fp32 for each kernel's fp32 instance (``<kernel>_f32``)
   at every distinct shape of the fp32 path (an ``edit``, an ``edit_batch``
   of two and a quality-mode edit), on seeded random fp32 inputs with TF32
   off, with the same planted faults, the fp32 tolerance and fp32 library
   calls (``F.conv2d``, SDPA); fewer repeats (a graph of 5 calls, 3 eager
   calls).  The six fp32 kernels on the tensor cores (3xTF32: the stride-1,
   fused, upsample and stride-2 convs, the D = 64 and the D = 512 attention;
   the convs on the TF32 hi and lo copies of the weight or of the upsample
   conv's phase weights, split once as the conv modules split them) are also
   held against an fp64 reference computed on the card, within 8x the plain
   fp32 version's max |err| against it, and the single-pass TF32 emulation
   (``ops/tf32x3.py``, the lo products dropped) must fall outside that limit
   at every shape; their bound counts three TF32 operations per fp32 one at
   494.7 TFLOP/s (the bound at the fp32 rate outside the tensor cores, 67
   TFLOP/s, beside it), GroupNorm's at 67 TFLOP/s.  Before all that, every
   kernel of every library is held to the tensor-core rule by name: the bf16
   kernels and the six 3xTF32 ones hold HGMMA, no kernel holds HMMA, every
   other kernel (the fp32 GroupNorm kernels and the Canny kernels, which must
   be built, among them) no tensor-core instruction at all.  The Canny
   kernel's three entries (``canny_prepare``, what an edit launches, one
   device kernel a call; ``canny_front`` and ``canny_hysteresis``; bf16 and
   fp32 outputs) are held bit for bit against their plain versions at batch
   1, 2 and 4 at 1024², on the test images and smooth images with long edges
   at three threshold pairs (one swapped), the hysteresis also on random
   candidates at densities 0.1 to 0.6, at batch 1 the edges against
   ``canny_np`` and the hysteresis on a 1024² serpentine (one chain of ~524k
   pixels) against ``scipy.ndimage.label``; planted faults, each a copy of
   ``csrc/canny.cu`` built beside the kernels and launched on the card: cv2's
   horizontal NMS tie rule flipped, the unions across tile edges taken out,
   each block's last tile skipped.
3. The main path in the default configuration:
   ``FastEditor("ssd-1b", random_weights=True)`` at 1024², a warm-up, three
   ``edit()`` calls and one ``edit_batch`` of two images, on CUDA graphs
   (``pipeline/graphs.py``).  Seconds per edit and device ms per stage (the
   editor's CUDA events around prepare and each graph replay), peak memory,
   and each kernel's launches: a replay makes no Python call, so the
   wrappers count the two keys' first calls, each an eager warm-up and a
   capture, which must come to twice the inventory's counts per key; and
   the device kernels of one replayed edit and one replayed batch of two,
   by name (``torch.profiler``), which must come to the inventory's counts
   (the phase-weight fold: none, it runs once per weight).  Prepare (Canny)
   is the first graph of each key's chain.  From here on every call of the
   prompt encoder must launch the LayerNorm kernel as often as the
   inventory's prompt sites say, and those launches are taken off the
   wrappers' counts (``account_prompt_launches``): the launch checks are the
   edit path's.  Then one new
   prompt's host ms (to the return, and to a sync) and device ms (the
   editor's CUDA events) on the prompt graph and on the eager arm, in turns;
   and one eager kernel prepare, then the dispatch of a replayed
   ``edit_batch_async``, each under ``torch.cuda.set_sync_debug_mode(
   "error")``, which must raise nothing.  No LayerNorm of the phase (nor of
   phase 8) may take the plain version on the card (``layer_norm.plain_on_card``),
   nor any attention call of 128 q rows or more (``attention.plain_on_card``).
4. Kernels against plain versions end to end, with seeded fan-in-scaled
   weights: one edit on graphs (a new key: warm-up and capture, twice the
   inventory's launches), the same edit on the eager arm
   (``flags.override(cuda_graphs=False)``: the inventory's launches), which
   must give the same bits, and one with
   ``flags.override(plain_versions=True)``; final latents and images of the
   graphs against the plain edit.  Two plain edits with a planted fault
   (attention, conv) are read against the plain edit beside the limits.
5. Graphs against the eager arm, bit for bit in the final latents and the
   uint8 images, with the seeded weights: batch 1 with CFG, batch 1 without,
   an ``edit_batch`` of two; a second replay of a key on new inputs (image,
   prompt, seed, another schedule of three steps, other scales) against a
   fresh eager edit of them, which must capture no new key.
   One key replayed at the thresholds (100, 200), (50, 150) and (200, 100):
   the control image its prepare graph wrote equals ``canny_np``'s edges at
   each, the edit equals the eager arm's bit for bit, and no key is captured.
   The prompt graph against the eager arm, bit for bit, for 1, 3 and 5 novel
   prompts (padded counts 1, 4 and 8), and a cached prompt's row unchanged
   after a later prompt replayed the same key (the cache holds copies).
   Then the graph cache's memory rule: ``pipeline/graphs.MEMORY_BUDGET``
   patched to what is in use plus the largest capture so far and 0.1 GiB,
   six new keys must evict older ones and keep the card's memory in use
   within the budget after every capture (reserved bytes and their peak
   printed).
6. A converted checkpoint, with the seeded weights of phases 4-5: the five
   models written as an HF-style fp16 snapshot (``config.json`` from the
   port's vendored public configs, diffusers / transformers names, the
   port's safetensors writer) with a small BPE vocabulary, converted by
   ``python -m fastedit_tpu_torch.tools.convert_checkpoint`` (all components
   at once, ``--expect ssd-1b`` / ``controlnet-small`` / ``vae``), loaded by
   ``FastEditor("ssd-1b", checkpoint_dir=...)``: an ``edit`` and an
   ``edit_batch`` of two on graphs, bit for bit against the in-memory editor
   after the same bf16 -> fp16 -> bf16 round trip, and the device kernels of
   one replayed edit against the inventory.  The UNet converted again with a
   seeded rank-64 kohya LoRA (with alpha) over its attention projections:
   the fused tensors against W + alpha / rank * up @ down in fp32 on the
   card (the conv tolerance; the unfused weights must fail it), and that
   checkpoint's edit against an in-memory fuse within phase 4's limits.
   Then ``MetricsCalculator(allow_random=True)`` at full width on four
   (source, edited, prompt) triples: every value finite, the batch equal to
   the per-pair calls, SSIM / PSNR / MSE of an image with itself 1 / inf / 0.
   Temporary files live under ``build/chip_smoke_checkpoint`` and are
   removed whatever happens, after phase 7.
7. The CLIs at full width, on phase 6's converted checkpoint, through their
   ``main(argv)`` in this process (files under ``build/chip_smoke_cli``,
   removed whatever happens): ``tools.make_demo_data`` (six 512² images);
   ``run_single_image --compute_metrics --profile`` (a 1024² JPEG, the six
   metrics, a trace); ``run_batch`` sequentially (the wrappers' launches
   over the sweep twice the inventory's for its graph key: one warm-up and
   one capture), with ``--data_parallel`` (bit for bit the sequential
   sweep's images and comparison figures) and again with
   ``--skip_existing`` (six skipped); all three ``--save_comparisons``; two
   ``run_batch`` processes joined over gloo on the one card, a placeholder
   output planted (one skipped on each, 2 + 3 processed, the images bit for
   bit the sequential sweep's); ``evaluate --allow_random_metrics`` (the
   ``examples/tiny_results`` schemas, every value finite); and
   ``run_benchmark ssd-1b`` on the demo set (SSIM, PSNR and MSE finite, the
   learned metrics NaN without weights, the summary, three figures and the
   archive); ``run_single_image --full_precision`` (fp32, the kernels' fp32
   instances) and ``--quality_mode``, which must fail only for the
   checkpoint's missing ``controlnet_full``.
8. The fp32 path: ``FastEditor("ssd-1b", random_weights=True,
   use_full_precision=True)`` at 1024² on graphs, after the bf16 editors are
   freed: a warm-up, two ``edit()`` calls and one ``edit_batch`` of two, with
   seconds per edit, device ms per stage, peak memory, the wrappers' launches
   (twice the fp32 inventory: every call on an fp32 kernel, no bf16 kernel)
   and one replayed edit's device kernels by name; then two edits at guidance
   1.0 (no CFG, a key of its own), timed the same way.  With seeded weights: an
   edit on graphs against the same edit eagerly (bit for bit) and with
   ``plain_versions=True`` (within 1e-3 latent rel L2 and 0.5 LSB mean; a
   plain edit whose stride-1 convs skip their last chunk of 32 input
   channels, the fp32 kernel's, must fail those limits), and the card memory
   the conv modules' TF32 weight copies take.  Last, one quality-mode edit
   (``use_full_controlnet=True``) with its launches against the inventory of
   the full ControlNet.  Also, with the seeded weights: the fp32 prompt
   graph, captured with TF32 allowed in the process, equals the text
   encoders run with TF32 off (which TF32 moves), and one request through
   ``serve.EditService`` gives the graphs' edit of the same input bit for
   bit.
9. Serving, run right after phase 5 on its editor (seeded weights, bf16,
   default flags): ``serve.EditService(max_batch=4)``, its warm-up at batch
   1, 2 and 4 (seconds and memory in use per key), ``make_http_server(port=0)``
   on a thread, and 1024² JPEG requests from client threads: one alone (a new
   prompt, then the same prompt cached); four at once with seed 7 (one batch
   of four; each image and its final latents within phase 4's limits of a
   solo ``edit`` of the same image, prompt and seed, its rows matched to the
   requests by the order the batch encoded their prompts in); three at once (padded
   to four, three images back); two that differ only in guidance (two
   batches); a burst of 16 new prompts (requests per minute, latency, the
   batch histogram); a bad body (400), an unknown route (404), a service
   with no queue (503), a request queued behind two batches of four past a
   short timeout (504, its future cancelled); ``close()`` with six requests
   in flight (every future resolved).  The burst's wall time is split into
   the card's work (the editor's CUDA events of each batch) and the host's:
   the dispatcher's calls of the editor, split by part (``dispatch_split``),
   and the time the card did not work.
   The wrappers' launches over the phase must be twice the inventory's for
   each key it captured.
10. ``python -m fastedit_tpu_torch.tools.conformance`` (``main([])``): the
   card against the CPU, exit 0, the flash attention and GroupNorm kernels
   launched; then its SSIM check with TF32 allowed (outside
   ``true_fp32()``), which must fail, or where TF32 leaves the stress pair
   within its tolerance, with the card's SSIM inputs cast to bf16, which
   must; and its Canny checks (through the kernels, the Canny kernel
   launched) with the hysteresis run without its unions across tile edges,
   which must fail its stress chains.
11. Tensor parallelism on one card, right after phase 9 on its editor:
   ``enable_data_parallel(["cuda:0", "cuda:0"], model_parallel=2)`` (the
   transformer linears split in two shards on the one card), an
   ``edit_batch`` of two images on the kernels and CUDA graphs (a TP
   replica pins no flag) against the same edit without TP, within phase 4's
   limits; the replica's captures and its kernels' launches (the shards'
   flash attention, the convs, GroupNorm, Canny), seconds per edit and the
   peak memory; the same group run eagerly (``cuda_graphs=False``: its
   seconds and peak memory, the same bits as the graphs').  Then the arm
   across processes: ``python -m fastedit_tpu_torch.tools.multihost_dryrun``
   runs two processes joined over gloo, each with ``cuda:0`` as its one
   device, as one group of two (a shard each; the row-parallel partials
   through pinned host memory and gloo, eagerly), on phase 4's seeded
   weights and the same ``edit_batch`` and seed: each worker's owned rows
   against its own one-process recompute bit for bit; here the owner's rows
   against this process's eager group (the max difference) and against the
   edit without TP within phase 4's limits, each process's bytes sent per
   ``edit_batch`` against the reckoning (3,963,617,280 B), the flash
   attention, conv, GroupNorm and Canny kernels launched in each, each
   process's seconds per ``edit_batch`` and peak memory; the tool's session
   is killed past its time limit, which fails the phase.  Its fp32 arm runs
   inside phase 8, on the seeded fp32 editor: the same group and edit (on
   one process), within phase 8's fp32 limits, every launch an ``_f32``
   kernel's.

It prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``.  Per-shape kernel figures and the main-path timings are also
written to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

from fastedit_tpu_torch.tools.timing import PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S

ROOT = Path(__file__).resolve().parent
OUT_FILE = ROOT / "chiprun_out" / "chip_smoke.json"

# fp32 outside the tensor cores (FFMAs): the bound of an fp32 kernel that took
# its products there, beside its 3xTF32 bound
PEAK_F32_FLOPS = 67e12
# dense TF32 on the tensor cores: the fp32 kernels on wgmma take every fp32
# product as three TF32 products (3xTF32), so their bound is 3 x FLOPs at it
PEAK_TF32_FLOPS = 494.7e12
TF32X3_KERNELS = ("conv3x3_f32", "conv3x3_fused_f32", "conv3x3_up2_f32", "conv3x3_down2_f32",
                  "flash_attention_d64_f32", "flash_attention_d512_f32")
# The fp32 kernels on the tensor cores against an fp64 reference computed on
# the card, at every main-path shape: their max |err| within 8x that of the
# plain fp32 version (TF32 off), which single-pass TF32 (the lo products
# dropped, the plain emulation of ops/tf32x3.py) must exceed at every shape.
F64_GATE = 8.0

RESOLUTION = 1024
EDIT_KW = dict(strength=0.8, num_inference_steps=4, guidance_scale=1.5)

# Kernel vs plain version, per element, in bf16.  Both accumulate in fp32
# and round once to bf16, so they differ by the final rounding (one bf16
# ulp, at most 2^-7 of the value) plus fp32 summation-order differences,
# which matter only for outputs near zero: the absolute term.  It holds for
# every conv form and for the GroupNorm kernel.
CONV_REL, CONV_ABS_OF_MAX = 2.0**-7, 2.0**-10
# Attention: the same relative term; the absolute term scales with the
# RMS of the output, which shrinks as 1/sqrt(Skv) for a flat softmax.  It
# lies between the worst reading of the kernel and that of a planted fault
# (the plain version with the kernel's last KV tile skipped), both read on
# the card in every run (phase 2).
ATTN_REL, ATTN_ABS_OF_RMS = 2.0**-7, 2.0**-3
# GroupNorm's |mean| >> std input: bf16 values 384 and 386 (one in 512 is
# 386): std ~0.09, far below what fp32 resolves of E[x^2] ~ 147456 (ulp
# 2^-6), so a one-pass variance is noise while the two-pass one is exact.
GN_OFFSET, GN_SPIKE, GN_SPIKE_RATE = 384.0, 2.0, 1.0 / 512
# End to end (phase 4): the paths agree per op within the bounds above, and
# bf16 rounding differences (2^-9 relative) at some 200 sequential layers
# per step over 3 steps leave a few percent at most in the final latents.
# Planted faults are read in the same run, against the plain edit: a conv
# kernel that skips its last Cin step must fail these limits.  A skipped
# attention KV tile moves the latents no more than bf16 rounding does, so
# it is recorded only; phase 2 catches it.
E2E_LATENT_REL_L2 = 5e-2
E2E_IMAGE_MEAN_LSB = 4.0
# fp32 (phase 2's fp32 rows): kernel and plain version both sum in fp32 in
# other orders; the relative term is the repo's golden 2e-4, the absolute term
# 1e-4 of the largest |ref| covers GroupNorm on the |mean| >> std input,
# where two fp32 means of values ~384 differ by ~2e-5 and the output
# multiplies that by 1 / std ~ 11 (read 1.5e-3 of max |ref| ~60 on the card).
F32_REL, F32_ABS_OF_MAX = 2e-4, 1e-4
# fp32 attention: the absolute term over the output's RMS, between the sound
# kernel's reading (~1e-4) and a skipped KV tile's (> 1e-2), both read here.
F32_ATTN_ABS_OF_RMS = 1e-3
# fp32 end to end (phase 8): both paths in fp32 differ by summation order
# alone, far below bf16's 0.05 and 4; a stride-1 conv that skips its last
# chunk of 32 input channels must fail these limits.
F32_E2E_LATENT_REL_L2 = 1e-3
F32_E2E_IMAGE_MEAN_LSB = 0.5
# phase 2's fp32 rows: a graph of 5 calls replayed twice, 3 eager calls (the
# fp32 kernels take milliseconds; the bf16 rows keep 20 and 10)
F32_GRAPH = dict(reps=2, calls=5)
F32_EAGER_REPS = 3


def log(*args) -> None:
    print(*args, flush=True)


def count_hgmma(library_path: Path, opcodes=("HGMMA",)) -> dict:
    """Warpgroup MMA instructions (SASS ``HGMMA``, what ``wgmma.mma_async``
    compiles to; or any of ``opcodes``) per kernel of a built library, from
    ``cuobjdump -sass``; empty where the toolkit has no ``cuobjdump``."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(library_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name is not None and any(op in line for op in opcodes):
            counts[name] += 1
    return counts


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def is_f32(kernel: str) -> bool:
    return kernel.endswith("_f32")


def kernel_peak(kernel: str) -> float:
    """The rate a kernel's operations are bounded by: bf16 at the bf16
    tensor-core rate, the 3xTF32 kernels at three TF32 operations per fp32
    one, the other fp32 kernels (GroupNorm) at the fp32 rate."""
    if kernel in TF32X3_KERNELS:
        return PEAK_TF32_FLOPS / 3.0
    return PEAK_F32_FLOPS if is_f32(kernel) else PEAK_BF16_FLOPS


def kernel_bound(kernel: str, flops: float, nbytes: float) -> tuple[float, str]:
    return bound_ms(flops, nbytes, kernel_peak(kernel))


def fp64_gate(what: str, out, plain, single_pass, ref64) -> dict:
    """The gate of the 3xTF32 kernels: max |out - ref64| within F64_GATE x
    max |plain - ref64|, and single-pass TF32 outside that limit."""
    plain_err = float((plain.double() - ref64).abs().max())
    err = float((out.double() - ref64).abs().max())
    single = float((single_pass.double() - ref64).abs().max())
    limit = F64_GATE * plain_err
    res = dict(fp64_err=err, fp64_plain_err=plain_err, fp64_limit=limit,
               fp64_single_pass_err=single, fp64_ratio=err / plain_err,
               fp64_single_pass_ratio=single / plain_err)
    log(f"  fp64 gate {what}: kernel {err:.3e} ({err / plain_err:.3f} x plain fp32 "
        f"{plain_err:.3e}), limit {limit:.3e}; single-pass TF32 {single:.3e} "
        f"({single / plain_err:.1f} x)")
    if not err <= limit:
        raise AssertionError(f"{what}: max |err| vs fp64 {err} above {F64_GATE} x the plain "
                             f"fp32 version's {plain_err}")
    if not single > limit:
        raise AssertionError(f"{what}: the fp64 limit {limit} passes single-pass TF32 ({single});"
                             " tighten it")
    return res


def n_outside(out, ref, rel: float, abs_tol: float) -> int:
    """Elements with |out - ref| > rel * |ref| + abs_tol, or not finite."""
    d = (out.float() - ref.float()).abs()
    return int((~(d <= rel * ref.float().abs() + abs_tol)).sum())


def check_close(what: str, out, ref, rel: float, abs_tol: float) -> tuple[float, float]:
    """Raise unless |out - ref| <= rel * |ref| + abs_tol everywhere; return
    (max abs error, max abs error / max |ref|)."""
    d = (out.float() - ref.float()).abs()
    n_bad = n_outside(out, ref, rel, abs_tol)
    err, scale = float(d.max()), float(ref.float().abs().max())
    if n_bad or not bool(out.float().isfinite().all()):
        raise AssertionError(
            f"{what}: {n_bad} elements outside tolerance (max abs err {err}, "
            f"max |ref| {scale})"
        )
    return err, err / max(scale, 1e-30)


def conv_tol(ref, f32: bool = False) -> float:
    """The absolute term of the kernel tolerance (bf16 kernels, or with
    ``f32`` the fp32 ones): a share of max |ref|."""
    return (F32_ABS_OF_MAX if f32 else CONV_ABS_OF_MAX) * float(ref.float().abs().max())


def err_over_rms(out, ref, rel: float) -> float:
    """The least c for which |out - ref| <= rel * |ref| + c * rms(ref)
    holds everywhere."""
    d = (out.float() - ref.float()).abs() - rel * ref.float().abs()
    return float(d.max().clamp(min=0.0)) / float(ref.float().square().mean().sqrt())


# ------------------------------------------------------------------ phase 2


def kernel_shapes():
    """Kernel calls per edit of the SSD-1B edit path at 1024², keyed by
    (kernel, shape): one ``edit`` and one ``edit_batch`` of two in bf16 and
    in fp32, and one fp32 edit in the quality mode (the full ControlNet)."""
    from fastedit_tpu_torch.models import configs as C
    from fastedit_tpu_torch.tools import inventory

    import torch

    args = (C.SSD1B_UNET, C.SDXL_CONTROLNET_SMALL, C.SDXL_VAE, RESOLUTION)
    sites = {b: inventory.edit_sites(*args, batch=b, steps=3) for b in (1, 2)}
    calls = {f"default_b{b}": inventory.kernel_calls(sites[b]) for b in (1, 2)}
    for b in (1, 2):  # the fp32 path: the same calls, on the fp32 instances
        calls[f"f32_b{b}"] = inventory.kernel_calls(sites[b], dtype=torch.float32)
    quality = inventory.edit_sites(C.SSD1B_UNET, C.SDXL_CONTROLNET_FULL, C.SDXL_VAE, RESOLUTION,
                                   batch=1, steps=3)
    calls["f32_quality_b1"] = inventory.kernel_calls(quality, dtype=torch.float32)
    return calls


def call_counts(calls: dict, kernel: str, key) -> dict:
    """A row's calls per configuration: an edit, a batch of two and (fp32)
    the quality-mode edit."""
    if is_f32(kernel):
        return dict(calls_edit=calls["f32_b1"].get((kernel, key), 0),
                    calls_edit_batch2=calls["f32_b2"].get((kernel, key), 0),
                    calls_edit_quality=calls["f32_quality_b1"].get((kernel, key), 0))
    return dict(calls_edit=calls["default_b1"].get((kernel, key), 0),
                calls_edit_batch2=calls["default_b2"].get((kernel, key), 0))


def keys_of(calls: dict, kernel: str) -> list:
    return sorted({key for c in calls.values() for (k, key) in c if k == kernel}, key=str)


def _parts(t) -> tuple:
    return tuple(t) if isinstance(t, (tuple, list)) else (t,)


def hold_close(what: str, out, ref, f32: bool = False) -> tuple[float, float]:
    """``check_close`` with the kernel tolerance (the fp32 kernels' with
    ``f32``), part by part where the outputs are tuples (the GroupNorm
    statistics' scale and shift, each held to its own scale)."""
    rel = F32_REL if f32 else CONV_REL
    errs = [check_close(what, o, r, rel, conv_tol(r, f32))
            for o, r in zip(_parts(out), _parts(ref), strict=True)]
    return max(e for e, _ in errs), max(r for _, r in errs)


def outside(out, ref, f32: bool = False) -> int:
    rel = F32_REL if f32 else CONV_REL
    return sum(n_outside(o, r, rel, conv_tol(r, f32))
               for o, r in zip(_parts(out), _parts(ref), strict=True))


def hold(calls, kernel, key, kern, plain, library, flops, nbytes, faults=None,
         extra=None) -> dict:
    """Check ``kern()`` against ``plain()`` with the conv tolerance (and every
    planted fault of ``faults``, by name, against it, which must fail), then
    time the kernel, the plain version and the library call (``None`` where
    no one PyTorch call computes the same function).  One row of the
    per-shape table."""
    import torch

    from fastedit_tpu_torch.tools.timing import graph_ms, time_ms

    f32 = is_f32(kernel)
    out, ref = kern(), plain()
    torch.cuda.synchronize()
    err, rel = hold_close(f"{kernel} {key}", out, ref, f32)
    row = dict(kernel=kernel, shape=list(key), max_abs_err=err, max_rel_err=rel)
    for name, make in (faults or {}).items():
        bad = outside(make(), ref, f32)
        row[f"{name}_elements_outside"] = bad
        if bad == 0:
            raise AssertionError(f"{kernel} {key}: the tolerance passes the planted {name}")
    del out, ref
    b_ms, b_by = kernel_bound(kernel, flops, nbytes)
    if kernel in TF32X3_KERNELS:
        row["bound_simt_ms"] = bound_ms(flops, nbytes, PEAK_F32_FLOPS)[0]
    gkw, reps = (F32_GRAPH, F32_EAGER_REPS) if f32 else ({}, 10)
    row.update(extra or {})
    row.update(
        **call_counts(calls, kernel, key),
        ms=graph_ms(kern, **gkw), library_ms=graph_ms(library, **gkw) if library else None,
        plain_ms=time_ms(plain, reps), eager_ms=time_ms(kern, reps),
        library_eager_ms=time_ms(library, reps) if library else None,
        bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
    )
    row["tflops"] = flops / row["ms"] / 1e9
    log(kernel, list(key), {k: row[k] for k in (
        "max_abs_err", "max_rel_err", "ms", "library_ms", "plain_ms", "eager_ms",
        "library_eager_ms", "bound_ms", "tflops")},
        {k: v for k, v in row.items() if k.endswith("_elements_outside")},
        {k: row[k] for k in ("plan", "prologue_exps") if k in row})
    return row


def _conv_operands(gen, n, h, w, cin, cout, dtype=None):
    import torch

    dtype = dtype or torch.bfloat16
    x = torch.randn((n, h, w, cin), generator=gen, device="cuda").to(dtype)
    wt = torch.randn((cout, cin, 3, 3), generator=gen, device="cuda") * (9 * cin) ** -0.5
    wt = wt.to(dtype).contiguous(memory_format=torch.channels_last)
    bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
    return x, wt, bias


def _suffix(dtype) -> tuple[str, int]:
    """The kernel name's suffix for ``dtype`` (``_f32`` for fp32) and its
    item size."""
    import torch

    return ("_f32", 4) if dtype == torch.float32 else ("", 2)


def plan_of(x, cout: int, down2_asymmetric=None, up2: bool = False,
            fused: bool = False) -> dict:
    """The conv kernel's schedule for this call (stride 1, fused, the
    upsample form, or stride 2 where ``down2_asymmetric`` says which padding),
    as a row records it, for ``x``'s dtype (fp32: the 3xTF32 kernel's, the
    plans at item size 4)."""
    from fastedit_tpu_torch.ops.conv3x3 import plan_down2_for, plan_for, plan_up2_for

    if down2_asymmetric is not None:
        pl = plan_down2_for(x, cout, down2_asymmetric)
    elif up2:
        pl = plan_up2_for(x, cout)
    else:
        pl = plan_for(x, cout, fused)
    return dict(rect=list(pl.rect), bn=pl.bn, tiles=pl.tiles, grid=pl.grid,
                smem_bytes=pl.smem_bytes)


def weight_bytes(taps: int, cin: int, cout: int, sfx: str) -> float:
    """Bytes of the weights a conv kernel reads: bf16, or (fp32) the TF32 hi
    and lo copies, 8 bytes a weight."""
    return (8.0 if sfx else 2.0) * taps * cin * cout


def neighbour_halo(xin, wt):
    """The fp32 conv of NHWC ``xin`` whose padding row above each image holds
    the last row of the image before it in the batch instead of zeros: what a
    tile that straddles two images computes along an image's top edge."""
    import torch.nn.functional as F

    xp = F.pad(xin.float(), (0, 0, 1, 1, 1, 1))
    xp[:, 0, 1:-1] = xin.float().roll(1, dims=0)[:, -1]
    return F.conv2d(xp.permute(0, 3, 1, 2), wt.float()).permute(0, 2, 3, 1)


def compare_conv(calls: dict, gen, dtype=None) -> list[dict]:
    """Fault, at batch 2: the halo row above an image taken from the
    neighbouring image.  Library: ``F.conv2d`` in the dtype (bf16, or fp32
    without TF32).  fp32: the 3xTF32 kernel on the weight's TF32 hi and lo
    copies, split once as the conv modules split them, and its fp64 gate."""
    import torch.nn.functional as F

    from fastedit_tpu_torch.ops import conv3x3 as k
    from fastedit_tpu_torch.ops import conv_fused as cf
    from fastedit_tpu_torch.ops import tf32x3

    sfx, isz = _suffix(dtype)
    rows = []
    for key in keys_of(calls, "conv3x3" + sfx):
        n, h, w, cin, cout = key
        x, wt, bias = _conv_operands(gen, n, h, w, cin, cout, dtype)
        x_nchw, bias_dt = x.permute(0, 3, 1, 2), bias.to(x.dtype)
        faults = {}
        if n > 1:
            faults["neighbour_halo"] = lambda: (neighbour_halo(x, wt) + bias).to(x.dtype)
        extra = dict(plan=plan_of(x, cout))
        w_split = cf.split_tf32(wt) if sfx else None
        if sfx:
            ref64 = F.conv2d(x_nchw.double(), wt.double(), bias.double(), padding=1)
            extra.update(fp64_gate(
                f"conv3x3_f32 {key}", k.conv3x3(x, wt, bias, w_split=w_split),
                k.conv3x3_plain(x, wt, bias), tf32x3.conv3x3_plain(x, wt, bias, passes=1),
                ref64.permute(0, 2, 3, 1)))
            del ref64
        rows.append(hold(
            calls, "conv3x3" + sfx, key,
            lambda: k.conv3x3(x, wt, bias, w_split=w_split), lambda: k.conv3x3_plain(x, wt, bias),
            lambda: F.conv2d(x_nchw, wt, bias_dt, padding=1),
            flops=2.0 * n * h * w * cout * 9 * cin,
            nbytes=(isz * (n * h * w * cin + n * h * w * cout) + weight_bytes(9, cin, cout, sfx)
                    + 4.0 * cout),
            faults=faults, extra=extra,
        ))
    return rows


def host_us_per_launch(calls: dict, gen, launches: int = 200, trials: int = 5) -> list[dict]:
    """Host microseconds per call of ``conv3x3``, ``conv3x3_down2`` and
    ``flash_attention`` (D = 64), each at the main path's smallest shape
    (``tools/timing.host_us``: to enqueue, and with one synchronise at the
    end; the least of ``trials`` runs of ``launches`` calls)."""
    import math

    import torch

    from fastedit_tpu_torch.ops import conv3x3 as k
    from fastedit_tpu_torch.ops import conv_fused as cf
    from fastedit_tpu_torch.ops import flash_attention as fa
    from fastedit_tpu_torch.tools.timing import host_us

    def smallest(kernel):
        return min(keys_of(calls, kernel), key=lambda s: math.prod(int(v) or 1 for v in s))

    conv_key, down_key, attn_key = (smallest(n) for n in (
        "conv3x3", "conv3x3_down2", "flash_attention_d64"))
    x, wt, bias = _conv_operands(gen, *conv_key)
    xd, wd, bd = _conv_operands(gen, *down_key[:5])
    b, sq, skv, h, d = attn_key
    q, kk, v = (torch.randn((b, s_, h, d), generator=gen, device="cuda").bfloat16()
                for s_ in (sq, skv, skv))
    rows = []
    for name, key, fn in (
            ("conv3x3", conv_key, lambda: k.conv3x3(x, wt, bias)),
            ("conv3x3_down2", down_key,
             lambda: cf.conv3x3_down2(xd, wd, bd, asymmetric=down_key[5])),
            ("flash_attention_d64", attn_key, lambda: fa.flash_attention(q, kk, v))):
        enqueue_us, us = host_us(fn, launches, trials)
        log(f"host us per {name} launch at {list(key)}: {enqueue_us:.2f} to enqueue, {us:.2f} "
            "with one synchronise at the end")
        rows.append(dict(kernel=name, shape=list(key), launches=launches, trials=trials,
                         host_enqueue_us_per_launch=enqueue_us, host_us_per_launch=us))
    return rows


def compare_fused(calls: dict, gen, dtype=None) -> list[dict]:
    """The fused resnet conv with its prologue, per-batch or shared bias
    and skip as the key says.  Fault: the prologue applied to the padded
    input, so the ring holds silu(shift) instead of zero.  Library: the
    bare conv (``F.conv2d``), without the prologue and epilogue.  fp32: the
    3xTF32 kernel on the weight's TF32 hi and lo copies, split once as the
    conv modules split them, and its fp64 gate."""
    import torch
    import torch.nn.functional as F

    from fastedit_tpu_torch.ops import conv_fused as cf
    from fastedit_tpu_torch.ops import tf32x3
    from fastedit_tpu_torch.ops.conv3x3 import plan_for

    sfx, isz = _suffix(dtype)
    rows = []
    for key in keys_of(calls, "conv3x3_fused" + sfx):
        n, h, w, cin, cout, per_batch_bias, has_skip = key
        x, wt, bias = _conv_operands(gen, n, h, w, cin, cout, dtype)
        if per_batch_bias:
            bias = torch.randn((n, cout), generator=gen, device="cuda") * 0.1
        scale = torch.rand((n, cin), generator=gen, device="cuda") + 0.5
        shift = torch.randn((n, cin), generator=gen, device="cuda") * 0.5
        skip = (torch.randn((n, h, w, cout), generator=gen, device="cuda").to(x.dtype)
                if has_skip else None)
        pre = (scale, shift)

        def finish(out):
            out = out + (bias[:, None, None, :] if bias.dim() == 2 else bias)
            return (out if skip is None else out + skip.float()).to(x.dtype)

        def ring_not_zeroed():
            xp = F.pad(x, (0, 0, 1, 1, 1, 1))  # NHWC, zero ring
            xr = cf.prologue_plain(xp, scale, shift)
            return finish(F.conv2d(xr.permute(0, 3, 1, 2).float(),
                                   wt.float()).permute(0, 2, 3, 1))

        faults = {"fault": ring_not_zeroed}
        if n > 1:
            faults["neighbour_halo"] = lambda: finish(
                neighbour_halo(cf.prologue_plain(x, scale, shift), wt))

        x_nchw, bias_dt = x.permute(0, 3, 1, 2), bias.reshape(-1, cout)[0].to(x.dtype)
        nbytes = (isz * (n * h * w * cin + n * h * w * cout * (2 if skip is not None else 1))
                  + weight_bytes(9, cin, cout, sfx) + 4.0 * (bias.numel() + 2 * n * cin))
        extra = dict(plan=plan_of(x, cout, fused=True),
                     prologue_exps=plan_for(x, cout, True).prologue_exps(n, h, w, cin))
        w_split = cf.split_tf32(wt) if sfx else None
        if sfx:
            xin = F.silu(x.double() * scale.double()[:, None, None, :]
                         + shift.double()[:, None, None, :])
            ref64 = F.conv2d(xin.permute(0, 3, 1, 2), wt.double(), padding=1).permute(0, 2, 3, 1)
            ref64 += bias.double()[:, None, None, :] if bias.dim() == 2 else bias.double()
            if skip is not None:
                ref64 += skip.double()
            del xin
            extra.update(fp64_gate(
                f"conv3x3_fused_f32 {key}",
                cf.conv3x3_fused(x, wt, bias, pre, skip=skip, w_split=w_split),
                cf.conv3x3_fused_plain(x, wt, bias, pre, skip=skip),
                tf32x3.conv3x3_fused_plain(x, wt, bias, pre, skip=skip, passes=1), ref64))
            del ref64
        rows.append(hold(
            calls, "conv3x3_fused" + sfx, key,
            lambda: cf.conv3x3_fused(x, wt, bias, pre, skip=skip, w_split=w_split),
            lambda: cf.conv3x3_fused_plain(x, wt, bias, pre, skip=skip),
            lambda: F.conv2d(x_nchw, wt, bias_dt, padding=1),
            flops=2.0 * n * h * w * cout * 9 * cin, nbytes=nbytes,
            faults=faults, extra=extra,
        ))
    return rows


def compare_up2(calls: dict, gen, dtype=None) -> list[dict]:
    """Fault: phase (1, 1) with its two tap rows swapped; at batch 2 also the
    halo row above an image taken from the neighbouring image.  Library: the
    materialised upsample and the conv, two calls (``repeat_interleave`` +
    ``F.conv2d``).  The kernel takes its phase weights folded once
    (``fold_up2``; fp32: their TF32 hi and lo copies, ``split_up2``), as on the
    main path; fp32 also the fp64 gate."""
    import torch.nn.functional as F

    from fastedit_tpu_torch.ops import conv_fused as cf
    from fastedit_tpu_torch.ops import tf32x3

    sfx, isz = _suffix(dtype)
    rows = []
    for key in keys_of(calls, "conv3x3_up2" + sfx):
        n, h, w, cin, cout = key
        x, wt, bias = _conv_operands(gen, n, h, w, cin, cout, dtype)
        phases = cf.make_phase_kernels(wt)
        swapped = phases.clone()
        swapped[1, 1] = phases[1, 1].flip(0)
        # once, as the upsampler modules fold (fp32: and split) them
        folded = cf.split_up2(wt) if sfx else cf.fold_up2(wt)
        x_nchw, bias_dt = x.permute(0, 3, 1, 2), bias.to(x.dtype)

        def kern():
            if sfx:
                return cf.conv3x3_up2(x, wt, bias, w_split=folded)
            return cf.conv3x3_up2(x, wt, bias, phases=folded)

        def library():
            up = x_nchw.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            return F.conv2d(up, wt, bias_dt, padding=1)

        faults = {"fault": lambda: cf.up2_phases_plain(x, swapped, bias)}
        if n > 1:
            faults["neighbour_halo"] = lambda: (neighbour_halo(
                x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2), wt) + bias).to(x.dtype)
        extra = dict(plan=plan_of(x, cout, up2=True))
        if sfx:
            up64 = x_nchw.double().repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            ref64 = F.conv2d(up64, wt.double(), bias.double(), padding=1).permute(0, 2, 3, 1)
            del up64
            extra.update(fp64_gate(
                f"conv3x3_up2_f32 {key}", kern(), cf.conv3x3_up2_plain(x, wt, bias),
                tf32x3.conv3x3_up2_plain(x, wt, bias, passes=1), ref64))
            del ref64
        rows.append(hold(
            calls, "conv3x3_up2" + sfx, key, kern,
            lambda: cf.conv3x3_up2_plain(x, wt, bias),
            library, flops=32.0 * n * h * w * cin * cout,
            nbytes=(isz * (n * h * w * cin + 4 * n * h * w * cout)
                    + (weight_bytes(16, cin, cout, sfx) if sfx else 2.0 * 9 * cin * cout)
                    + 4.0 * cout),
            faults=faults, extra=extra,
        ))
    return rows


def compare_down2(calls: dict, gen, dtype=None) -> list[dict]:
    """Fault: the other padding ((1, 1) where (0, 1) is asked, and the
    reverse).  Library: ``F.conv2d(stride=2)`` (after ``F.pad`` for the
    asymmetric padding)."""
    import torch.nn.functional as F

    from fastedit_tpu_torch.ops import conv_fused as cf

    sfx, isz = _suffix(dtype)
    rows = []
    for key in keys_of(calls, "conv3x3_down2" + sfx):
        n, h, w, cin, cout, asym = key
        x, wt, bias = _conv_operands(gen, n, h, w, cin, cout, dtype)
        x_nchw, bias_dt = x.permute(0, 3, 1, 2), bias.to(x.dtype)

        def library():
            if asym:
                return F.conv2d(F.pad(x_nchw, (0, 1, 0, 1)), wt, bias_dt, stride=2)
            return F.conv2d(x_nchw, wt, bias_dt, stride=2, padding=1)

        ho, wo = h // 2, w // 2
        extra = dict(plan=plan_of(x, cout, down2_asymmetric=asym))
        # fp32: the 3xTF32 kernel on the weight's TF32 hi and lo copies, split once as the
        # downsampler modules split them, and its fp64 gate
        w_split = cf.split_tf32(wt) if sfx else None
        if sfx:
            from fastedit_tpu_torch.ops import tf32x3

            pad = (0, 1, 0, 1) if asym else (1, 1, 1, 1)
            ref64 = F.conv2d(F.pad(x_nchw.double(), pad), wt.double(), bias.double(), stride=2)
            extra.update(fp64_gate(
                f"conv3x3_down2_f32 {key}",
                cf.conv3x3_down2(x, wt, bias, asymmetric=asym, w_split=w_split),
                cf.conv3x3_down2_plain(x, wt, bias, asymmetric=asym),
                tf32x3.conv3x3_down2_plain(x, wt, bias, asymmetric=asym, passes=1),
                ref64.permute(0, 2, 3, 1)))
            del ref64
        rows.append(hold(
            calls, "conv3x3_down2" + sfx, key,
            lambda: cf.conv3x3_down2(x, wt, bias, asymmetric=asym, w_split=w_split),
            lambda: cf.conv3x3_down2_plain(x, wt, bias, asymmetric=asym),
            library, flops=2.0 * n * ho * wo * cout * 9 * cin,
            nbytes=(isz * (n * h * w * cin + n * ho * wo * cout) + weight_bytes(9, cin, cout, sfx)
                    + 4.0 * cout),
            faults={"fault": lambda: cf.conv3x3_down2_plain(x, wt, bias, asymmetric=not asym)},
            extra=extra,
        ))
    return rows


def device_kernels(fn, calls: int = 3, tries: int = 5) -> list[str]:
    """The names of the device kernels one call of ``fn`` runs, by
    ``torch.profiler`` (CUDA activity) over ``calls`` calls (at least 2).
    The profiler drops the records at the ends of its window: the first ones
    (a few kernels, or every kernel of the first ~50 ms and more in a profile
    taken late in a long process), so a long spin (``torch.cuda._sleep``)
    opens and closes the window, and a group of eight short marker spins
    stands before each call and after the last.  Records are dropped only at
    the ends, so a call is whole when a spin survived on either side of it;
    at least two whole calls must run the same kernels (as a multiset: the
    streams' kernels may interleave differently), and then one of them is
    returned.  A profile without two is taken again with spins four times as
    long, up to ``tries`` in all, and it raises when every try failed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if calls < 2:
        raise ValueError(f"device_kernels needs two calls or more to compare, got {calls}")

    def marks():
        torch.cuda.synchronize()
        for _ in range(8):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    seen = []
    for attempt in range(tries):
        spin = 100_000_000 * 4**attempt  # cycles: ~50 ms at the first try
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(spin)
            for _ in range(calls):
                marks()
                fn()
            marks()
            torch.cuda._sleep(spin)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        names = [e.name for e in events]
        spins = [i for i, name in enumerate(names) if "spin_kernel" in name]
        whole = [names[a + 1:b] for a, b in zip(spins, spins[1:]) if b > a + 1]
        agree = [w for w in whole if sorted(w) == sorted(whole[-1])] if whole else []
        seen.append((len(names), len(spins), [len(w) for w in whole]))
        if len(whole) >= 2 and len(agree) == len(whole):
            if attempt:
                log(f"device_kernels: the profiler dropped records in {attempt} tries "
                    f"(device kernels, spins, kernels of each whole call: {seen})")
            return whole[-1]
    raise AssertionError(f"the profiler lost records in all {tries} tries of {calls} calls "
                         f"(device kernels, spins, kernels of each whole call: {seen})")


def compare_group_norm(calls: dict, gen, dtype=None) -> list[dict]:
    """The GroupNorm kernel (``group_norm``) and its statistics alone
    (``group_norm_scale_shift``, the fused resnet conv's (scale, shift)).
    Three inputs per shape: normal values, held and timed, with the planted
    merge fault read on them wherever the plan takes clusters: the kernel
    built from a copy of ``csrc/group_norm.cu`` whose clusters leave their
    last block's partial out of their merge (:data:`MERGE_FAULT`); the
    |mean| >> std input, held too, with the planted one-pass variance read
    on it; and a step (the last sixteenth of each image's pixels 32 higher),
    held too.  Each call must run one device kernel (the
    profiler counts them), on every route.  Library: ``F.group_norm`` (+
    ``F.silu``) on channels_last
    NCHW for GroupNorm; for the statistics ``torch.var_mean`` over each
    group's pixels and channels, the reduction that dominates them (the
    fold with the affine into scale and shift is a few hundred elements)."""
    import torch
    import torch.nn.functional as F

    from fastedit_tpu_torch.ops import fused_groupnorm as fg
    from fastedit_tpu_torch.ops.groupnorm import group_norm_plain, group_norm_scale_shift_plain

    def one_pass_stats(x, groups):
        b, h, w, c = x.shape
        xf = x.float().reshape(b, h * w, groups, c // groups)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = xf.square().mean(dim=(1, 3), keepdim=True) - mean.square()
        return xf, mean, var

    def one_pass(x, gamma, beta, groups, act):
        xf, mean, var = one_pass_stats(x, groups)
        out = ((xf - mean) * torch.rsqrt(var + 1e-5)).reshape(x.shape) * gamma + beta
        return (F.silu(out) if act == "silu" else out).to(x.dtype)

    def one_pass_scale_shift(x, gamma, beta, groups):
        _, mean, var = one_pass_stats(x, groups)
        cg = x.shape[-1] // groups
        scale = torch.rsqrt(var + 1e-5)[:, 0, :, 0].repeat_interleave(cg, dim=1) * gamma
        return scale, beta - mean[:, 0, :, 0].repeat_interleave(cg, dim=1) * scale

    dtype = dtype or torch.bfloat16
    sfx, isz = _suffix(dtype)
    f32 = bool(sfx)
    rows = []
    for base in ("group_norm", "group_norm_scale_shift"):
        kernel = base + sfx
        for key in keys_of(calls, kernel):
            n, h, w, c, groups = key[:5]
            act = key[5] if base == "group_norm" else None
            if base == "group_norm":
                def kern(x):
                    return fg.fused_group_norm(x, gamma, beta, groups, 1e-5, act)

                def plain(x):
                    return group_norm_plain(x, gamma, beta, groups, 1e-5, act)

                def fault(x):
                    return one_pass(x, gamma, beta, groups, act)

                def merge_fault(x):
                    return group_norm_with_fault(x, gamma, beta, groups, act)
            else:
                def kern(x):
                    return fg.group_norm_scale_shift(x, gamma, beta, groups, 1e-5)

                def plain(x):
                    return group_norm_scale_shift_plain(x, gamma, beta, groups, 1e-5)

                def fault(x):
                    return one_pass_scale_shift(x, gamma, beta, groups)

                def merge_fault(x):
                    return group_norm_with_fault(x, gamma, beta, groups, stats=True)
            gamma = torch.randn(c, generator=gen, device="cuda") * 0.5 + 1.0
            beta = torch.randn(c, generator=gen, device="cuda") * 0.2
            spikes = torch.rand((n, h, w, c), generator=gen, device="cuda") < GN_SPIKE_RATE
            offset = (GN_OFFSET + GN_SPIKE * spikes.float()).to(dtype)
            del spikes
            out, ref = kern(offset), plain(offset)
            torch.cuda.synchronize()
            off_err, _ = hold_close(f"{kernel} {key}, |mean| >> std", out, ref, f32)
            fault_bad = outside(fault(offset), ref, f32)
            del out, ref
            if fault_bad == 0:
                raise AssertionError(f"{kernel} {key}: the tolerance passes a one-pass variance")
            names = device_kernels(lambda: kern(offset))
            del offset
            if len(names) != 1:
                raise AssertionError(f"{kernel} {key}: {len(names)} device kernels per call "
                                     f"({names}), expected 1")
            step = torch.randn((n, h, w, c), generator=gen, device="cuda")
            step[:, (h * w * 15 // 16) // w:] += 32.0  # whole rows: ~the last sixteenth
            step = step.to(dtype)
            out, ref = kern(step), plain(step)
            torch.cuda.synchronize()
            step_err, _ = hold_close(f"{kernel} {key}, step", out, ref, f32)
            del out, ref, step

            x = (torch.randn((n, h, w, c), generator=gen, device="cuda") * 2.0 + 0.5).to(dtype)
            # the merge fault, read on the normal input: a block's M2 left out
            # takes 1/cluster of the variance away (its mean moves little)
            plan_x = fg.plan_for(x, groups)
            merge_bad = outside(merge_fault(x), plain(x), f32) if plan_x.cluster > 1 else None
            if merge_bad == 0:
                raise AssertionError(f"{kernel} {key}: the tolerance passes the kernel with a "
                                     "block left out of its cluster's merge")
            x_nchw = x.permute(0, 3, 1, 2)
            g_dt, b_dt = gamma.to(dtype), beta.to(dtype)

            x_groups = x.view(n, h * w, groups, c // groups)

            def library():
                if base == "group_norm_scale_shift":
                    return torch.var_mean(x_groups, dim=(1, 3), correction=0)
                y = F.group_norm(x_nchw, groups, g_dt, b_dt, 1e-5)
                return F.silu(y) if act == "silu" else y

            elems = n * h * w * c
            rows.append(hold(
                calls, kernel, key, lambda: kern(x), lambda: plain(x), library,
                flops=(8.0 if base == "group_norm" else 4.0) * elems,
                # x read once, and the output written once (x's dtype) or (scale, shift) (fp32)
                nbytes=isz * elems + 8.0 * c + (isz * elems if base == "group_norm"
                                                else 8.0 * n * c),
                extra=dict(offset_max_abs_err=off_err, fault_elements_outside=fault_bad,
                           step_max_abs_err=step_err, merge_fault_elements_outside=merge_bad,
                           device_kernels_per_call=len(names), device_kernel_names=names,
                           plan=gn_plan_of(x, groups)),
            ))
            del x, x_nchw, x_groups
        if not any(r["merge_fault_elements_outside"] for r in rows if r["kernel"] == kernel):
            raise AssertionError(f"{kernel}: no main-path shape took clusters, so the merge "
                                 "fault was read nowhere")
    return rows


def compare_layer_norm(calls: dict, gen, dtype=None) -> list[dict]:
    """The LayerNorm kernel (``layer_norm``) at the transformer blocks' shapes
    (an edit's, a batch of two's and a batch of four's: the benchmark's sweep)
    and at the CLIP text towers' (one call of the prompt encoder on an edit's
    two prompts; those rows count no calls per edit, their calls per prompt
    encoding are in ``prompt_calls``), with the share of 3.35 TB/s each
    reaches (``hbm_pct``).  Two inputs per shape: the |mean| >> std one of
    the GroupNorm rows, held, with a planted one-pass variance (E[x^2] -
    E[x]^2) read on it, which must fail; and normal values, held and timed.
    Each call must run one device kernel.  Library: ``F.layer_norm`` with the
    affine in x's dtype (the port never calls it)."""
    import torch
    import torch.nn.functional as F

    from fastedit_tpu_torch.models import configs as C
    from fastedit_tpu_torch.ops import layer_norm as ln
    from fastedit_tpu_torch.tools import inventory

    dtype = dtype or torch.bfloat16
    sfx, isz = _suffix(dtype)
    f32 = bool(sfx)
    kernel = "layer_norm" + sfx
    prompts = inventory.kernel_calls(
        inventory.prompt_sites(C.SDXL_TEXT_ENCODER, C.SDXL_TEXT_ENCODER_2, 2), dtype)
    sweep = inventory.kernel_calls(inventory.edit_sites(
        C.SSD1B_UNET, C.SDXL_CONTROLNET_SMALL, C.SDXL_VAE, RESOLUTION, batch=4, steps=3), dtype)
    keys = {*keys_of(calls, kernel), *(k for (name, k) in sweep if name == kernel), *(
        k for (_, k) in prompts)}
    rows = []
    for key in sorted(keys):
        n, s, c = key
        gamma = torch.randn(c, generator=gen, device="cuda") * 0.5 + 1.0
        beta = torch.randn(c, generator=gen, device="cuda") * 0.2

        def kern(x):
            return ln.fused_layer_norm(x, gamma, beta, 1e-5)

        def plain(x):
            return ln.layer_norm_plain(x, gamma, beta, 1e-5)

        def one_pass(x):
            xf = x.float()
            mean = xf.mean(dim=-1, keepdim=True)
            var = xf.square().mean(dim=-1, keepdim=True) - mean.square()
            return ((xf - mean) * torch.rsqrt(var + 1e-5) * gamma + beta).to(x.dtype)

        spikes = torch.rand((n, s, c), generator=gen, device="cuda") < GN_SPIKE_RATE
        offset = (GN_OFFSET + GN_SPIKE * spikes.float()).to(dtype)
        del spikes
        out, ref = kern(offset), plain(offset)
        torch.cuda.synchronize()
        off_err, _ = hold_close(f"{kernel} {key}, |mean| >> std", out, ref, f32)
        fault_bad = outside(one_pass(offset), ref, f32)
        del out, ref
        if fault_bad == 0:
            raise AssertionError(f"{kernel} {key}: the tolerance passes a one-pass variance")
        names = device_kernels(lambda: kern(offset))
        del offset
        if len(names) != 1:
            raise AssertionError(f"{kernel} {key}: {len(names)} device kernels per call "
                                 f"({names}), expected 1")
        x = (torch.randn((n, s, c), generator=gen, device="cuda") * 2.0 + 0.5).to(dtype)
        g_dt, b_dt = gamma.to(dtype), beta.to(dtype)

        def library():
            return F.layer_norm(x, (c,), g_dt, b_dt, 1e-5)

        elems = n * s * c
        rows.append(hold(
            calls, kernel, key, lambda: kern(x), lambda: plain(x), library,
            # sum, deviation, square, sum; deviation, scale, gamma, beta
            flops=8.0 * elems,
            # x read once, y written once, gamma and beta (fp32) once
            nbytes=2.0 * isz * elems + 8.0 * c,
            extra=dict(offset_max_abs_err=off_err, fault_elements_outside=fault_bad,
                       device_kernels_per_call=len(names), device_kernel_names=names,
                       prompt_calls=prompts.get((kernel, key), 0)),
        ))
        row = rows[-1]
        row["hbm_pct"] = 100.0 * row["bytes"] / (1e-3 * row["ms"]) / PEAK_HBM_BYTES_PER_S
        log(f"  {kernel} {list(key)}: {row['hbm_pct']:.1f}% of "
            f"{PEAK_HBM_BYTES_PER_S / 1e12:.2f} TB/s")
        del x
    return rows


def gn_plan_of(x, groups: int) -> dict:
    """The GroupNorm kernels' schedule for this call, as a row records it."""
    from fastedit_tpu_torch.ops.fused_groupnorm import plan_for

    pl = plan_for(x, groups)
    return dict(lanes=pl.lanes, threads=pl.threads, tile_px=pl.tile_px, stages=pl.stages,
                grid=list(pl.grid), cluster=pl.cluster, nclusters=pl.nclusters,
                max_tiles=pl.max_tiles, smem_bytes=pl.smem_bytes, route=pl.route,
                reread_bytes=pl.reread_bytes)


# The planted merge fault of GroupNorm: a copy of csrc/group_norm.cu whose
# clusters merge their blocks' partials but the last one's (its pixels still
# counted), built in the background beside the kernels.
MERGE_FAULT = ("cluster_merge_short", [("g < G ? p.cluster : 0, sub, sl,",
                                        "g < G ? p.cluster - 1 : 0, sub, sl,")])


def group_norm_with_fault(x, gamma, beta, groups: int, act=None, stats: bool = False):
    """GroupNorm (+ SiLU) or, with ``stats``, the statistics' (scale,
    shift), from the faulty copy of the kernel
    (:data:`MERGE_FAULT`), launched like ``ops/fused_groupnorm``'s wrappers
    (their counters untouched)."""
    import torch

    from fastedit_tpu_torch.ops import fused_groupnorm as fg

    libs = _faults["group_norm"].result()
    if MERGE_FAULT[0] not in libs:
        raise AssertionError("the faulty copy of csrc/group_norm.cu did not build")
    p = fg.plan_for(x, groups)
    sfx = "f32" if x.dtype == torch.float32 else "bf16"
    gamma, beta = gamma.float().contiguous(), beta.float().contiguous()
    part = torch.empty((p.b, p.nclusters, groups, 2), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    lib = libs[MERGE_FAULT[0]]
    if stats:
        ss = torch.empty((2, p.b, p.c), dtype=torch.float32, device=x.device)
        err = getattr(lib, f"group_norm_stats_{sfx}")(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ss.data_ptr(), part.data_ptr(),
            fg._counter(x, p.b).data_ptr(), *fg._plan_args(p), 1e-5, stream)
        out = (ss[0], ss[1])
    else:
        out = torch.empty_like(x)
        err = getattr(lib, f"group_norm_{sfx}")(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), part.data_ptr(),
            fg._counter(x, 4 * p.b).data_ptr(), *fg._plan_args(p), 1e-5, int(act == "silu"),
            stream)
    if err != 0:
        raise RuntimeError(f"the faulty group_norm failed: CUDA error {err}")
    return out


def compare_attention(calls: dict, gen, dtype=None) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from fastedit_tpu_torch.ops import flash_attention as fa
    from fastedit_tpu_torch.tools.timing import graph_ms, time_ms

    dtype = dtype or torch.bfloat16
    sfx, isz = _suffix(dtype)
    rel_tol, abs_of_rms = (F32_REL, F32_ATTN_ABS_OF_RMS) if sfx else (ATTN_REL, ATTN_ABS_OF_RMS)
    gkw, reps = (F32_GRAPH, F32_EAGER_REPS) if sfx else ({}, 10)
    rows, weak = [], []
    keys = sorted({key for c in calls.values() for (k, key) in c
                   if k.startswith("flash_attention") and k == f"flash_attention_d{key[4]}{sfx}"})
    for key in keys:
        b, sq, skv, h, d = key
        name = f"flash_attention_d{d}{sfx}"
        q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype)
        kk = torch.randn((b, skv, h, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, skv, h, d), generator=gen, device="cuda").to(dtype)
        out = fa.flash_attention(q, kk, v)
        ref = fa.attention_plain(q, kk, v)
        pl = fa.plan_f32(b, sq, skv, h, d) if sfx else fa.plan_for(q, skv)
        tile = pl.bkv  # one KV tile of the kernel that runs
        faulty = fa.attention_plain(q, kk[:, :-tile], v[:, :-tile])
        torch.cuda.synchronize()
        sound_c, fault_c = err_over_rms(out, ref, rel_tol), err_over_rms(faulty, ref, rel_tol)
        log("attention", name, list(key), f"err/rms kernel {sound_c:.6f}, "
            f"last KV tile skipped {fault_c:.5f}, limit {abs_of_rms}")
        if fault_c <= abs_of_rms:
            weak.append(f"{name} {key}: the tolerance passes "
                        f"a skipped KV tile ({fault_c} <= {abs_of_rms})")
        err, rel = check_close(
            f"{name} {key}", out, ref, rel_tol,
            abs_of_rms * float(ref.float().square().mean().sqrt()),
        )
        gate = {}
        if name in TF32X3_KERNELS:
            from fastedit_tpu_torch.ops import tf32x3

            del faulty
            qd, kd, vd = (t.double().transpose(1, 2) for t in (q, kk, v))
            ref64 = (torch.softmax((qd @ kd.transpose(-1, -2)) * d**-0.5, dim=-1) @ vd)
            del qd, kd, vd
            faulty = tf32x3.attention_plain(q, kk, v, passes=1)
            gate = fp64_gate(f"{name} {key}", out, ref, faulty, ref64.transpose(1, 2))
            del ref64
        del ref, out, faulty
        qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, v))
        flops = 4.0 * b * h * sq * skv * d
        nbytes = isz * b * h * d * (2 * sq + 2 * skv)
        b_ms, b_by = kernel_bound(name, flops, nbytes)
        if name in TF32X3_KERNELS:
            gate["bound_simt_ms"] = bound_ms(flops, nbytes, PEAK_F32_FLOPS)[0]
        plan = dict(bq=pl.bq, bkv=pl.bkv, tiles=pl.tiles, grid=pl.grid,
                    smem_bytes=pl.smem_bytes, stages=pl.stages)
        if not sfx or d == 512:
            plan.update(v_stages=pl.v_stages)
        rows.append(dict(
            kernel=name, shape=list(key), **call_counts(calls, name, key),
            max_abs_err=err, max_rel_err=rel, err_over_rms=sound_c,
            fault_err_over_rms=fault_c, **gate,
            ms=graph_ms(lambda: fa.flash_attention(q, kk, v), **gkw),
            library_ms=graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), **gkw),
            plain_ms=time_ms(lambda: fa.attention_plain(q, kk, v), reps),
            eager_ms=time_ms(lambda: fa.flash_attention(q, kk, v), reps),
            library_eager_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), reps),
            bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes, plan=plan,
        ))
        rows[-1]["tflops"] = flops / rows[-1]["ms"] / 1e9
        log("attention", rows[-1]["shape"], {k: rows[-1][k] for k in
            ("max_abs_err", "max_rel_err", "ms", "library_ms", "plain_ms", "eager_ms",
             "library_eager_ms", "bound_ms", "tflops", "plan")})
    if weak:
        raise AssertionError("\n".join(weak))
    return rows


# The cross-attention kernel against the plain version: both round P and O to
# bf16 at the same points, so an element differs only where an fp32 sum lands
# on a rounding boundary: at most CROSS_DIFFER_SHARE of them (the kernel read
# 0.027% at [2, 1024, 77, 20, 64]; P rounded before it is normalised, the flash
# kernels' order, 48%), and each within the attention tolerance's relative
# term and CROSS_ABS_OF_RMS of the output's RMS (the kernel read 0.0030; the
# padded keys left in the softmax 0.118, which K2's 2^-3 passes: 77 keys
# make a flat softmax that three more keys move by a few percent).
CROSS_DIFFER_SHARE = 0.01
CROSS_ABS_OF_RMS = 2.0**-5


def compare_cross_attention(calls: dict, gen, dtype=None) -> list[dict]:
    """The cross-attention kernel (``cross_attention``, bf16 only: fp32 keeps
    the plain version) at the UNet's cross shapes: an edit's and a batch of
    two's (SSD-1B and SDXL share them), and the benchmark sweep's batch of
    four (8 rows), with each model's calls per edit and per sweep chunk.
    Held to the plain version within ``ATTN_REL`` and ``CROSS_ABS_OF_RMS``
    and at most ``CROSS_DIFFER_SHARE`` of the elements differing; two
    planted faults must fail: the padded keys left in the softmax (the plain
    version over K and V padded with zeros to the plan's KV tile), against
    the tolerance, and P rounded before it is normalised, against the share.
    One device kernel a call; the share of 3.35 TB/s it reaches
    (``hbm_pct``, q read and O written once, K and V once); SDPA in bf16 as
    the yardstick."""
    import torch
    import torch.nn.functional as F

    from fastedit_tpu_torch.models import configs as C
    from fastedit_tpu_torch.ops import flash_attention as fa
    from fastedit_tpu_torch.tools import inventory
    from fastedit_tpu_torch.tools.timing import graph_ms, time_ms

    if dtype == torch.float32:
        return []
    kernel = "cross_attention"

    def per_edit(unet, batch):
        return inventory.kernel_calls(inventory.edit_sites(
            unet, C.SDXL_CONTROLNET_SMALL, C.SDXL_VAE, RESOLUTION, batch=batch, steps=3))

    models = {"ssd1b": C.SSD1B_UNET, "sdxl": C.SDXL_UNET}
    counts = {f"calls_{m}_b{b}": per_edit(unet, b)
              for m, unet in models.items() for b in (1, 2, 4)}
    keys = sorted({key for c in (*calls.values(), *counts.values()) for (k, key) in c
                   if k == kernel})
    rows = []
    for key in keys:
        b, sq, skv, h, d = key
        q = torch.randn((b, sq, h, d), generator=gen, device="cuda").bfloat16()
        kk = torch.randn((b, skv, h, d), generator=gen, device="cuda").bfloat16()
        v = torch.randn((b, skv, h, d), generator=gen, device="cuda").bfloat16()
        pl = fa.plan_cross(b, sq, skv, h, d, torch.cuda.get_device_properties(0)
                           .multi_processor_count)
        out, ref = fa.cross_attention(q, kk, v), fa.attention_plain(q, kk, v)
        pad = torch.zeros((b, pl.bkv - skv, h, d), dtype=kk.dtype, device="cuda")
        unmasked = fa.attention_plain(q, torch.cat([kk, pad], 1), torch.cat([v, pad], 1))
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * d**-0.5
        p = torch.exp(s - s.amax(-1, keepdim=True))
        del s
        round_first = (torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(), v.float())
                       / p.sum(-1).transpose(1, 2)[..., None]).bfloat16()
        del p
        torch.cuda.synchronize()
        sound, fault = err_over_rms(out, ref, ATTN_REL), err_over_rms(unmasked, ref, ATTN_REL)
        share = float((out != ref).float().mean())
        fault_share = float((round_first != ref).float().mean())
        log("attention", kernel, list(key), f"err/rms kernel {sound:.6f}, padded keys "
            f"unmasked {fault:.5f}, limit {CROSS_ABS_OF_RMS}; elements differing {share:.6f}, "
            f"P rounded first {fault_share:.4f}, limit {CROSS_DIFFER_SHARE}")
        if fault <= CROSS_ABS_OF_RMS:
            raise AssertionError(f"{kernel} {key}: the tolerance passes unmasked padded keys")
        if fault_share <= CROSS_DIFFER_SHARE:
            raise AssertionError(f"{kernel} {key}: the share passes P rounded before its sum")
        if share > CROSS_DIFFER_SHARE:
            raise AssertionError(f"{kernel} {key}: {share} of the elements differ from the "
                                 f"plain version, more than {CROSS_DIFFER_SHARE}")
        err, rel = check_close(f"{kernel} {key}", out, ref, ATTN_REL,
                               CROSS_ABS_OF_RMS * float(ref.float().square().mean().sqrt()))
        del out, ref, unmasked, round_first
        names = device_kernels(lambda: fa.cross_attention(q, kk, v))
        if len(names) != 1 or "flash_d64_kernel_cross<" not in names[0]:
            raise AssertionError(f"{kernel} {key}: device kernels per call {names}, expected "
                                 "one flash_d64_kernel_cross")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, v))
        flops = 4.0 * b * h * sq * skv * d
        nbytes = 2.0 * b * h * d * (2 * sq + 2 * skv)
        b_ms, b_by = kernel_bound(kernel, flops, nbytes)
        rows.append(dict(
            kernel=kernel, shape=list(key), **call_counts(calls, kernel, key),
            **{name: c.get((kernel, key), 0) for name, c in counts.items()},
            max_abs_err=err, max_rel_err=rel, err_over_rms=sound, fault_err_over_rms=fault,
            differ_share=share, fault_differ_share=fault_share,
            device_kernels_per_call=len(names), device_kernel_names=names,
            ms=graph_ms(lambda: fa.cross_attention(q, kk, v)),
            library_ms=graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            plain_ms=time_ms(lambda: fa.attention_plain(q, kk, v), 10),
            eager_ms=time_ms(lambda: fa.cross_attention(q, kk, v), 10),
            library_eager_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 10),
            bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
            plan=dict(bq=pl.bq, bkv=pl.bkv, tiles=pl.tiles, grid=pl.grid,
                      smem_bytes=pl.smem_bytes),
        ))
        row = rows[-1]
        row["tflops"] = flops / row["ms"] / 1e9
        row["hbm_pct"] = 100.0 * nbytes / (1e-3 * row["ms"]) / PEAK_HBM_BYTES_PER_S
        log("attention", kernel, row["shape"], {k: row[k] for k in (
            "ms", "library_ms", "plain_ms", "eager_ms", "library_eager_ms", "bound_ms",
            "hbm_pct", "plan")})
        del q, kk, v
    return rows


# The planted faults of the Canny kernel: copies of csrc/canny.cu built in the
# background beside the kernels.  The horizontal NMS keeps a pixel on m >= left
# and m > right (cv2's tie rule flipped); the unions across tile edges taken
# out (a chain that crosses a tile's edge breaks there); each block stops one
# tile early in its first phase (a block of one tile does none).
CANNY_FAULTS = {
    "front_tie_flipped": [
        ("const bool keep = m > m1 && (sector >= 2 ? m > m2 : m >= m2);",
         "const bool keep = sector == 0 ? m >= m1 && m > m2\n"
         "                                : m > m1 && (sector >= 2 ? m > m2 : m >= m2);")],
    "no_border_unions": [("    border_unions(a, tile_of",
                          "    if (false) border_unions(a, tile_of")],
    "last_tile_skipped": [("    if (t >= a.ntiles) break;",
                           "    if (t >= a.ntiles || next >= a.ntiles) break;")],
}
_faults: dict = {}  # library -> the future of its faulty copies' build


def start_fault_builds() -> None:
    """Start nvcc on the faulty copies of ``csrc/canny.cu`` and
    ``csrc/group_norm.cu`` (``tools/kernel_variants.build_variants``, one
    ``nvcc`` each, all at once) on threads of their own, after the kernels'
    own build, so the two builds do not share the cores."""
    from concurrent.futures import ThreadPoolExecutor

    from fastedit_tpu_torch.tools.kernel_variants import build_variants

    pool = ThreadPoolExecutor(2)
    _faults["canny"] = pool.submit(build_variants, "canny", CANNY_FAULTS)
    _faults["group_norm"] = pool.submit(build_variants, "group_norm", dict([MERGE_FAULT]))
    pool.shutdown(wait=False)


def canny_with_fault(fault: str, entry: str, x, dtype, low=None, high=None):
    """The faulty copy ``fault`` of the Canny kernel (:data:`CANNY_FAULTS`),
    launched on the card like ``ops/canny``'s wrappers (their counters
    untouched) into outputs filled with NaN and labels filled with
    ``canny.NONE``, so what it leaves unwritten differs: ``entry`` "prepare"
    (x an image) gives (control, VAE input), "front" (class map, VAE input),
    "hysteresis" (x a class map) the control."""
    import torch

    from fastedit_tpu_torch.ops import canny

    if "canny" not in _faults:
        start_fault_builds()
    libs = _faults["canny"].result()
    if fault not in libs:
        raise AssertionError(f"the faulty copy {fault} of csrc/canny.cu did not build")
    b, h, w = x.shape[:3]
    sfx = "f32" if dtype == torch.float32 else "bf16"
    grid = canny.plan_for(x, dtype).grid
    labels = torch.full((b, h, w), canny.NONE, dtype=torch.int32, device=x.device)
    control = torch.full((b, h, w, 3), float("nan"), dtype=dtype, device=x.device)
    vae_in = torch.full((b, h, w, 3), float("nan"), dtype=dtype, device=x.device)
    cls = torch.full((b, h, w), 7, dtype=torch.uint8, device=x.device)
    counter = canny._counter(x.device).data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    fn = getattr(libs[fault], f"canny_{entry}_{sfx}")
    if entry == "prepare":
        args, out = (x, low, high, labels, counter, control, vae_in), (control, vae_in)
    elif entry == "front":
        args, out = (x, low, high, counter, cls, vae_in), (cls, vae_in)
    else:
        args, out = (x, labels, counter, control), control
    err = fn(*(a if isinstance(a, int) else a.data_ptr() for a in args), b, h, w, grid, stream)
    if err != 0:
        raise RuntimeError(f"the faulty canny_{entry} ({fault}) failed: CUDA error {err}")
    return out


def smooth_image(seed: int, n: int = RESOLUTION):
    """A smooth RGB scene with long edges: soft ramps, a few large discs and
    bands (the edge chains run across many of the kernels' tiles)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:n, :n].astype(np.float64) / n
    img = np.stack([96 + 64 * np.sin(3 * xx + 2 * yy), 128 + 48 * np.cos(4 * yy),
                    80 + 60 * xx * yy], -1)
    for _ in range(6):
        cy, cx, r = rng.random(3) * [1, 1, 0.3] + [0, 0, 0.05]
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] += rng.integers(-90, 91, 3)
    for _ in range(3):
        a, c = rng.random(2) * [2, 1]
        img[np.abs(yy - a * xx - c + 0.5) < 0.02] += rng.integers(-80, 81, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


CANNY_THRESHOLDS = ((100, 200), (50, 150), (200, 100))
# Canny's operations per pixel (integer and fp32, outside the tensor cores):
# the front ~60 (gray 7, Sobel 16, magnitude 3, NMS ~25, the VAE input 9), the
# hysteresis ~10 (its runs, unions and write); far below their bytes, so bound
# by bytes at any rate.
CANNY_FRONT_OPS, CANNY_HYSTERESIS_OPS = 60.0, 10.0


def compare_canny(calls: dict, gen, dtype=None) -> list[dict]:
    """The Canny kernel's three entries, ``canny_prepare`` (what an edit
    launches: one device kernel a call, the profiler counts them),
    ``canny_front`` and ``canny_hysteresis``, bit for bit against their plain
    versions at the main path's batches (1, 2) and at batch 4 (serving's),
    1024²: on the phase's test images and on smooth images with long edges at
    three threshold pairs (one swapped), the hysteresis also on random
    candidates at densities 0.1 to 0.6; at batch 1 the edges against
    ``canny_np`` on the host, and the hysteresis on a 1024² serpentine (one
    chain of ~524k pixels, strong at one end) against ``scipy.ndimage.label``.
    Planted faults, each a built copy launched on the card
    (:data:`CANNY_FAULTS`): cv2's horizontal tie rule flipped (the front's
    class map), the unions across tile edges taken out (prepare, the
    serpentine), each block's last tile skipped (prepare).  Timed on the test
    images at (100, 200) (graph, eager, plain); no PyTorch call computes
    Canny (``library_ms`` null)."""
    import numpy as np
    import torch
    from scipy import ndimage

    from fastedit_tpu_torch.ops import canny
    from fastedit_tpu_torch.tools.conformance import stress_classes, serpentine
    from fastedit_tpu_torch.tools.timing import graph_ms, time_ms

    dtype = dtype or torch.bfloat16
    sfx, isz = _suffix(dtype)
    gkw, reps = (F32_GRAPH, F32_EAGER_REPS) if sfx else ({}, 10)
    rows = []
    keys = sorted(set(keys_of(calls, "canny_prepare" + sfx)) | {(4, RESOLUTION, RESOLUTION)})
    for key in keys:
        b, h, w = key
        photos = torch.from_numpy(np.stack([np.asarray(test_image(70 + i)) for i in range(b)]))
        smooth = torch.from_numpy(np.stack([smooth_image(80 + i) for i in range(b)]))
        photos, smooth = photos.cuda(), smooth.cuda()
        checked = 0
        faults = dict.fromkeys(CANNY_FAULTS, 0)
        for img in (photos, smooth):
            for low, high in CANNY_THRESHOLDS:
                lo, hi = canny.threshold_tensors(low, high, "cuda")
                control, vae_in = canny.prepare(img, lo, hi, dtype)
                cls, vae_front = canny.canny_front(img, lo, hi, dtype)
                cls_p, vae_p = canny.canny_front_plain(img, lo, hi, dtype)
                control_p = canny.canny_hysteresis_plain(cls_p, dtype)
                control_h = canny.canny_hysteresis(cls_p, dtype)
                torch.cuda.synchronize()
                for what, got, want in (
                        ("prepare's control", control, control_p),
                        ("prepare's VAE input", vae_in, vae_p), ("front's class map", cls, cls_p),
                        ("front's VAE input", vae_front, vae_p),
                        ("hysteresis' control", control_h, control_p)):
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"canny{sfx} {key} ({low}, {high}): the kernel's {what} differs "
                            f"from the plain version's in {int((got != want).sum())} values")
                faults["front_tie_flipped"] += int(
                    (canny_with_fault("front_tie_flipped", "front", img, dtype, lo, hi)[0]
                     != cls_p).sum())
                for fault in ("no_border_unions", "last_tile_skipped"):
                    bad_control, bad_vae = canny_with_fault(fault, "prepare", img, dtype, lo, hi)
                    faults[fault] += int((bad_control != control_p).sum()
                                         + (bad_vae != vae_p).sum())
                if b == 1 and img is photos:
                    ref = canny.canny_np(img[0].cpu().numpy(), low, high)
                    got = (control[0, ..., 0] > 0).cpu().numpy().astype(np.uint8) * 255
                    if not np.array_equal(got, ref):
                        raise AssertionError(f"canny{sfx} {key} ({low}, {high}): the kernel "
                                             f"differs from canny_np in {int((got != ref).sum())}"
                                             " pixels")
                checked += 1
        random_masks = {}
        for name, m in stress_classes(seed=b, size=h):
            if not name.startswith("random"):
                continue
            cls = torch.from_numpy(np.stack([m] * b)).cuda()
            control = canny.canny_hysteresis(cls, dtype)
            if not torch.equal(control, canny.canny_hysteresis_plain(cls, dtype)):
                raise AssertionError(f"canny_hysteresis{sfx} {key}: {name} differs from the "
                                     "plain version")
            random_masks[name] = graph_ms(lambda c=cls: canny.canny_hysteresis(c, dtype), **gkw)
        extra = {}
        if b == 1:
            chain = serpentine(h, w)
            cls = chain.astype(np.uint8)
            cls[tuple(np.argwhere(chain)[0])] = canny.STRONG
            labels, _ = ndimage.label(chain, np.ones((3, 3), bool))
            ct = torch.from_numpy(cls)[None].cuda()
            got = (canny.canny_hysteresis(ct, dtype)[0, ..., 0] > 0).cpu().numpy()
            if labels.max() != 1 or not np.array_equal(got, labels == 1):
                raise AssertionError(f"canny_hysteresis{sfx}: the 1024² serpentine differs "
                                     f"from scipy.ndimage.label in "
                                     f"{int((got != (labels == 1)).sum())} pixels")
            broken = (canny_with_fault("no_border_unions", "hysteresis", ct, dtype)[0, ..., 0]
                      > 0).cpu().numpy()
            extra = dict(serpentine_pixels=int(chain.sum()),
                         serpentine_ms=graph_ms(lambda: canny.canny_hysteresis(ct, dtype),
                                                **gkw),
                         serpentine_fault_pixels_missing=int((~broken & got).sum()))
            if not extra["serpentine_fault_pixels_missing"]:
                raise AssertionError("the serpentine passes a hysteresis without its unions "
                                     "across tile edges")
        if not all(faults.values()):
            raise AssertionError(f"canny{sfx} {key}: a planted fault passes (values that differ "
                                 f"from the plain version's: {faults})")
        lo, hi = canny.threshold_tensors(100, 200, "cuda")
        cls, _ = canny.canny_front(photos, lo, hi, dtype)
        kernels = device_kernels(lambda: canny.prepare(photos, lo, hi, dtype))
        if len(kernels) != 1 or "canny_kernel" not in kernels[0]:
            raise AssertionError(f"canny_prepare{sfx} {key}: one call ran {kernels}")
        px = b * h * w
        plan = canny.plan_for(photos, dtype)
        for name, kern, plain, ops, nbytes in (
                ("canny_prepare" + sfx, lambda: canny.prepare(photos, lo, hi, dtype),
                 lambda: canny.prepare_plain(photos, lo, hi, dtype),
                 CANNY_FRONT_OPS + CANNY_HYSTERESIS_OPS, px * (3 + 6 * isz) + 8),
                ("canny_front" + sfx, lambda: canny.canny_front(photos, lo, hi, dtype),
                 lambda: canny.canny_front_plain(photos, lo, hi, dtype), CANNY_FRONT_OPS,
                 px * (3 + 1 + 3 * isz) + 8),
                ("canny_hysteresis" + sfx, lambda: canny.canny_hysteresis(cls, dtype),
                 lambda: canny.canny_hysteresis_plain(cls, dtype), CANNY_HYSTERESIS_OPS,
                 px * (1 + 3 * isz))):
            b_ms, b_by = bound_ms(ops * px, nbytes, PEAK_F32_FLOPS)
            row = dict(kernel=name, shape=list(key), **call_counts(calls, name, key),
                       max_abs_err=0.0, max_rel_err=0.0, checked_inputs=checked,
                       fault_values_differing=faults,
                       plan=dict(grid=plan.grid, tiles_per_block=plan.tiles_per_block,
                                 smem_bytes=plan.smem_bytes),
                       ms=graph_ms(kern, **gkw), library_ms=None, library_eager_ms=None,
                       plain_ms=time_ms(plain, reps), eager_ms=time_ms(kern, reps),
                       bound_ms=b_ms, bound_by=b_by, flops=ops * px, bytes=nbytes)
            if name.startswith("canny_prepare"):
                row.update(device_kernels=kernels)
            if name.startswith("canny_hysteresis"):
                row.update(random_masks_ms=random_masks, **extra)
            rows.append(row)
            log(name, list(key), {k: v for k, v in row.items() if k not in ("kernel", "shape")})
        del photos, smooth
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


def check_launches(what: str, launches: dict, expected: dict) -> None:
    """Every kernel's launches equal the inventory's, and every kernel the
    inventory expects was launched."""
    log(f"launches ({what}):", launches, "expected:", expected)
    for name, n in expected.items():
        if launches.get(name) != n:
            raise AssertionError(f"{what}: {name} launched {launches.get(name)} times, "
                                 f"expected {n}")


# A launch of each wrapper runs these device kernels (a part of their
# demangled names): GroupNorm gn_kernel<T, true> on every route, the statistics
# entry gn_kernel<T, false> (T the element type); the
# fp32 convs are conv3x3_tf32x3_kernel, conv3x3_fused_tf32x3_kernel,
# conv3x3_up2_tf32x3_kernel and conv3x3_down2_tf32x3_kernel (their weight split
# runs once per weight), the fp32 attention split_qkv_tf32_kernel, then
# flash_d64_tf32x3_kernel or flash_d512_tf32x3_kernel; the self-attention
# kernel flash_d64_kernel<NWG> and the cross-attention kernel
# flash_d64_kernel_cross<NWG, BKV> are told apart by what follows the name.
WRAPPER_KERNELS = {
    "conv3x3": "conv3x3_kernel", "conv3x3_fused": "conv3x3_fused_kernel",
    "conv3x3_up2": "conv3x3_up2_kernel", "conv3x3_down2": "conv3x3_down2_kernel",
    "flash_attention_d64": "flash_d64_kernel<", "flash_attention_d512": "flash_d512_kernel",
    "cross_attention": "flash_d64_kernel_cross<",
    "up2_phase_weights": "up2_phase_weights_kernel",
    "conv3x3_f32": "conv3x3_tf32x3_kernel", "conv3x3_fused_f32": "conv3x3_fused_tf32x3_kernel",
    "conv3x3_down2_f32": "conv3x3_down2_tf32x3_kernel",
    "conv3x3_up2_f32": "conv3x3_up2_tf32x3_kernel",
    "flash_attention_d64_f32": "flash_d64_tf32x3_kernel",
    "flash_attention_d512_f32": "flash_d512_tf32x3_kernel",
}
GN_TYPES = {"": "__nv_bfloat16", "_f32": "float"}


def wrapper_launches(names: list) -> dict:
    """Wrapper -> its launches among the device kernels ``names``."""
    def count(part):
        return sum(part in name for name in names)

    out = {wrapper: count(part) for wrapper, part in WRAPPER_KERNELS.items()}
    for sfx, t in GN_TYPES.items():
        out["layer_norm" + sfx] = count(f"ln_kernel<{t},")
        out["canny_prepare" + sfx] = count(f"canny_kernel<{t}, 0>")
        out["group_norm" + sfx] = count(f"gn_kernel<{t}, true>")
        out["group_norm_scale_shift" + sfx] = count(f"gn_kernel<{t}, false>")
    return out


def account_prompt_launches() -> None:
    """Wrap ``pipeline/stages.encode_prompt``, which every prompt encoding
    runs (eagerly, or as a prompt graph's warm-up and capture): each call
    must launch the LayerNorm kernel as often as ``inventory.prompt_sites``
    routes to it (none under ``plain_versions``), and those launches are then
    taken off the wrapper's counts, so that the launch checks of the edit
    path (the inventory's ``edit_sites``, which hold no prompt) stay exact
    whatever prompts a phase encodes."""
    from fastedit_tpu_torch.ops import flags
    from fastedit_tpu_torch.ops import layer_norm as ln
    from fastedit_tpu_torch.pipeline import stages
    from fastedit_tpu_torch.tools import inventory

    real = stages.encode_prompt

    def encode_prompt(mod, ids_1, ids_2):
        before = (ln.launches, ln.launches_f32)
        out = real(mod, ids_1, ids_2)
        got = ln.launches + ln.launches_f32 - sum(before)
        sites = inventory.prompt_sites(mod.text_encoder.config, mod.text_encoder_2.config,
                                       ids_1.shape[0])
        want = 0 if flags.FLAGS.plain_versions else sum(inventory.kernel_calls(sites).values())
        if got != want:
            raise AssertionError(f"a prompt encoding of {ids_1.shape[0]} launched the LayerNorm "
                                 f"kernel {got} times, the inventory {want}")
        ln.launches, ln.launches_f32 = before
        return out

    stages.encode_prompt = encode_prompt


@contextlib.contextmanager
def plain_layer_norms_on_card(what: str):
    """The body must run no LayerNorm on the card outside the kernel's gate
    (``profiling`` counter ``layer_norm.plain_on_card``)."""
    from fastedit_tpu_torch.utils import profiling

    before = profiling.counters().get("layer_norm.plain_on_card", 0)
    yield
    plain = profiling.counters().get("layer_norm.plain_on_card", 0) - before
    log(f"{what}: {plain} LayerNorm calls on the card outside the kernel's gate")
    if plain:
        raise AssertionError(f"{what}: {plain} LayerNorm calls took the plain version on the card")


@contextlib.contextmanager
def plain_attention_on_card(what: str):
    """The body must run no attention call of 128 q rows or more on the card
    outside both kernels' gates (``profiling`` counter
    ``attention.plain_on_card``): the bf16 main path's cross-attention is the
    cross-attention kernel's."""
    from fastedit_tpu_torch.utils import profiling

    before = profiling.counters().get("attention.plain_on_card", 0)
    yield
    plain = profiling.counters().get("attention.plain_on_card", 0) - before
    log(f"{what}: {plain} attention calls on the card outside the kernels' gates")
    if plain:
        raise AssertionError(f"{what}: {plain} attention calls took the plain version on the card")


def check_image(img) -> None:
    import numpy as np

    arr = np.asarray(img)
    if arr.dtype != np.uint8 or arr.shape != (RESOLUTION, RESOLUTION, 3):
        raise AssertionError(f"edit returned {arr.dtype} {arr.shape}")


def main_path(calls: dict):
    import torch

    from fastedit_tpu_torch import FastEditor
    from fastedit_tpu_torch.pipeline.graphs import STAGES
    from fastedit_tpu_torch.tools.inventory import (
        launch_counts, launches_by_kernel, reset_launch_counts)

    t0 = time.perf_counter()
    editor = FastEditor("ssd-1b", random_weights=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    images = [test_image(1), test_image(2)]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    warm_s = editor.warmup(**EDIT_KW)
    log(f"editor built in {build_s:.2f} s, warm-up edit (eager run and capture) {warm_s:.2f} s")
    edits = []
    for i in range(3):
        t = time.perf_counter()
        out = editor.edit(images[0], "a watercolor painting of a harbor", seed=i, **EDIT_KW)
        edits.append(dict(seconds=time.perf_counter() - t, stage_ms=editor.stage_ms()))
        check_image(out)
        log(f"edit {i}: {edits[-1]['seconds']:.4f} s", edits[-1]["stage_ms"])
    t = time.perf_counter()
    outs = editor.edit_batch(images, ["a snowy street", "a city at night"], seed=3, **EDIT_KW)
    batch = dict(seconds=time.perf_counter() - t, stage_ms=editor.stage_ms())
    for out in outs:
        check_image(out)
    log(f"edit_batch of 2 (its first call: eager run and capture): {batch['seconds']:.4f} s",
        batch["stage_ms"])
    t = time.perf_counter()
    outs = editor.edit_batch(images, ["a snowy street", "a city at night"], seed=4, **EDIT_KW)
    batch_replay = dict(seconds=time.perf_counter() - t, stage_ms=editor.stage_ms())
    log(f"edit_batch of 2, replayed: {batch_replay['seconds']:.4f} s", batch_replay["stage_ms"])
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 1024**3
    keys = edit_captures(editor)
    if len(keys) != 2 or any(tuple(c.graphs) != STAGES for c in keys.values()):
        raise AssertionError(f"expected two keys of four graphs each ({STAGES}), got "
                             f"{list(keys)}")

    per_edit = launches_by_kernel(calls["default_b1"])
    per_batch2 = launches_by_kernel(calls["default_b2"])
    expected = {k: 2 * (per_edit[k] + per_batch2[k]) for k in per_edit}
    check_launches("two keys' first calls (eager warm-up and capture each), then replays",
                   launches, expected)
    pools = {str(k[:5]): c.pool_bytes / 1024**3 for k, c in keys.items()}
    log(f"peak device memory {peak_gib:.3f} GiB; graph pool GiB by key {pools}")
    replays = {}
    for what, edit, expected in (
            ("edit", lambda: editor.edit(images[0], "a watercolor painting of a harbor",
                                         seed=5, **EDIT_KW), per_edit),
            ("edit_batch of 2", lambda: editor.edit_batch(
                images, ["a snowy street", "a city at night"], seed=6, **EDIT_KW), per_batch2)):
        replays[what] = wrapper_launches(device_kernels(edit))
        check_launches(f"one replayed {what}, device kernels by the profiler",
                       replays[what], {**expected, "up2_phase_weights": 0})
    if len(edit_captures(editor)) != 2:
        raise AssertionError(f"the profiled replays captured another key: {list(keys)}")
    prompt = prompt_encode_times(editor)
    if launch_counts() != launches:  # the LayerNorm's, inventoried, are taken off
        raise AssertionError("encoding prompts launched a kernel of the port")
    no_sync = prepare_without_a_sync(editor, images)
    return editor, dict(no_sync_prepare=no_sync, 
        editor_build_s=build_s, warmup_s=warm_s, edits=edits, edit_batch2=batch,
        edit_batch2_replay=batch_replay, launches=launches, launches_per_edit=per_edit,
        replay_launches=replays, peak_gib=peak_gib, graph_pool_gib=pools, prompt_encode=prompt,
    )


def prepare_without_a_sync(editor, images) -> dict:
    """One eager kernel prepare, the thresholds copied in as the editor
    copies them, under ``torch.cuda.set_sync_debug_mode("error")``: a host
    sync anywhere in it raises.  Its device ms and launches."""
    import numpy as np
    import torch

    from fastedit_tpu_torch.ops import canny
    from fastedit_tpu_torch.pipeline import stages

    staged = editor.stage_inputs(np.stack([np.asarray(im) for im in images]))
    torch.cuda.synchronize()
    before = dict(canny.launches)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.set_sync_debug_mode("error")
    try:
        start.record()
        low, high = canny.threshold_tensors(60, 170, editor.device)
        control, vae_in = stages.prepare(editor.modules, staged, low, high, editor._control_res)
        end.record()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    end.synchronize()
    launched = {k: canny.launches[k] - before[k] for k in before}
    if launched != {**dict.fromkeys(canny.launches, 0), "canny_prepare": 1}:
        raise AssertionError(f"the eager prepare launched {launched}")
    res = dict(device_ms=start.elapsed_time(end), batch=len(images), launches=launched)
    log("[3] an eager kernel prepare under sync debug mode 'error': no sync;", res)
    # the whole dispatch of a replayed key (cached prompts, new thresholds), as
    # serving's dispatcher makes it: no host read between the batch and the replay
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = editor.edit_batch_async(images, ["a snowy street", "a city at night"],
                                          seed=4, canny_low_threshold=70,
                                          canny_high_threshold=160, **EDIT_KW)
        res["dispatch_sync"] = None
    except RuntimeError as e:
        pending, res["dispatch_sync"] = None, str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if pending is not None:
        pending.result()
    log("[3] a replayed edit_batch_async's dispatch under sync debug mode 'error':",
        res["dispatch_sync"] or "no sync")
    if res["dispatch_sync"] is not None:
        raise AssertionError(f"a replayed edit's dispatch reads the card on the host: "
                             f"{res['dispatch_sync']}")
    return res


def edit_captures(editor) -> dict:
    """The editor's captures of the edit's three graphs, by key (not its
    prompt graphs')."""
    eg = editor._graphs
    return {k: eg.captured[k] for k in eg.edit_keys()}


def prompt_encode_times(editor, reps: int = 5) -> dict:
    """One new prompt, on the prompt graph and on the eager arm in turns
    (after one unrecorded round): the host ms to the return of
    ``_encode_prompts`` (tokenizing, the copies in, the replay or the eager
    launches), the host ms to a sync after it, and the device ms between the
    editor's CUDA events around the replay or the eager encode; medians."""
    import statistics

    import torch

    from fastedit_tpu_torch.ops import flags

    rows: dict = {"graph": [], "eager": []}
    for i in range(reps + 1):
        for arm in rows:
            torch.cuda.synchronize()
            times = editor._stage_times()
            t = time.perf_counter()
            with flags.override(cuda_graphs=arm == "graph"):
                editor._encode_prompts([f"a new prompt to time, {arm} {i}"], times)
            host = time.perf_counter() - t
            torch.cuda.synchronize()
            synced = time.perf_counter() - t
            if i:
                rows[arm].append(dict(host_ms=1e3 * host, synced_ms=1e3 * synced,
                                      device_ms=times.read()["encode_prompt"]))
    out = {arm: {k: statistics.median(r[k] for r in rs) for k in rs[0]}
           for arm, rs in rows.items()}
    out["reps"] = reps
    log("[3] one new prompt, medians of", reps, "(host ms to return, to a sync, device ms):",
        out)
    return out


# ------------------------------------------------------------------ phase 4

# the seeded weights of phases 4-7, 9 and 11 (``tools/multihost_dryrun.py
# --init_seed`` draws the same on its own editors)
WEIGHT_SEED = 20261016


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
    gate: ``attention`` skips the last KV tile of the kernel's plan, as a
    kernel whose loop stops one tile short; ``conv`` skips the last Cin step (64 channels) of the
    last tap, as a kernel whose K loop stops one step short; ``conv_f32``
    skips the fp32 kernel's last chunk of input channels (32, or what is left
    of Cin past the last multiple of 32; every tap)."""
    from fastedit_tpu_torch.ops import conv3x3, flash_attention

    if kind == "attention":
        # the module, not the function that ``ops/__init__.py`` exports
        module, name = sys.modules["fastedit_tpu_torch.ops.attention"], "attention_plain"
        orig = module.attention_plain

        def faulty(q, k, v, scale=None):
            if flash_attention.supports(tuple(q.shape), k.shape[1]):
                b, sq, h, d = q.shape
                tile = flash_attention.plan(b, sq, k.shape[1], h, d).bkv
                k, v = k[:, :-tile], v[:, :-tile]
            return orig(q, k, v, scale)
    else:
        module, name = conv3x3, "conv3x3_plain"
        orig = conv3x3.conv3x3_plain

        def faulty(x, weight, bias=None, act=None):
            w = weight.clone()
            if kind == "conv_f32":
                w[:, (w.shape[1] - 1) // conv3x3.F32_CHUNK * conv3x3.F32_CHUNK:] = 0
            else:
                w[:, (w.shape[1] - 1) // 64 * 64:, 2, 2] = 0
            return orig(x, w, bias, act)
    setattr(module, name, faulty)
    try:
        yield
    finally:
        setattr(module, name, orig)


def differ(a, b) -> dict:
    """(uint8 images, final latents) pairs: their distance."""
    import numpy as np

    diff = np.abs(a[0].astype(np.int32) - b[0].astype(np.int32))
    return dict(latent_rel_l2=float((a[1].float() - b[1].float()).norm() / b[1].float().norm()),
                image_mean_abs_lsb=float(diff.mean()), image_max_abs_lsb=int(diff.max()))


def same_bits(what: str, a, b) -> None:
    """Graphs against the eager arm: the same uint8 images and final latents."""
    import numpy as np

    if not (np.array_equal(a[0], b[0]) and bool((a[1] == b[1]).all())):
        raise AssertionError(f"{what}: graphs and the eager arm differ: {differ(a, b)}")


def edit_arrays(editor, images, prompts, **kw):
    """One ``edit_batch``: (uint8 images [B, r, r, 3], final latents, host
    seconds, device ms per stage)."""
    import numpy as np

    t = time.perf_counter()
    outs = editor.edit_batch(images, prompts, **kw)
    sec = time.perf_counter() - t
    lat = editor.last_latents.clone()
    if not bool(lat.isfinite().all()):
        raise AssertionError("non-finite final latents")
    return np.stack([np.asarray(o) for o in outs]), lat, sec, editor.stage_ms()


def kernels_vs_plain(editor, calls: dict) -> dict:
    import torch

    from fastedit_tpu_torch.ops import flags
    from fastedit_tpu_torch.tools.inventory import (
        launch_counts, launches_by_kernel, reset_launch_counts)

    seeded_weights_(editor, seed=WEIGHT_SEED)  # drops the graphs: the weights changed
    img, prompt = test_image(5), "an oil painting of a lighthouse"
    editor._encode_prompts([prompt, ""])

    def run(fault=None, **override):
        with flags.override(**override), (planted_fault(fault) if fault
                                          else contextlib.nullcontext()):
            return edit_arrays(editor, [img], [prompt], seed=11, **EDIT_KW)

    def within_limits(what, res):
        if (res["latent_rel_l2"] > E2E_LATENT_REL_L2
                or res["image_mean_abs_lsb"] > E2E_IMAGE_MEAN_LSB):
            raise AssertionError(
                f"{what}: kernel edit differs from plain edit beyond tolerance "
                f"(latents rel L2 <= {E2E_LATENT_REL_L2}, image mean <= "
                f"{E2E_IMAGE_MEAN_LSB} LSB): {res}"
            )

    inventory = launches_by_kernel(calls["default_b1"])
    reset_launch_counts()
    kern = run()  # a new key: eager warm-up, capture, replay
    launches = launch_counts()
    check_launches("one edit on graphs (a new key)", launches,
                   {k: 2 * n for k, n in inventory.items()})
    reset_launch_counts()
    eager = run(cuda_graphs=False)
    check_launches("one edit on the eager arm", launch_counts(), inventory)
    same_bits("the kernel plan", kern, eager)
    before = launch_counts()
    plain = run(plain_versions=True)
    if launch_counts() != before:
        raise AssertionError("a plain-version edit launched a kernel")
    res = dict(differ(kern, plain), image_std=float(plain[0].std()),
               latent_std=float(plain[1].float().std()), seconds_graphs_first_call=kern[2],
               seconds_eager=eager[2], seconds_plain=plain[2],
               stage_ms_graphs=kern[3], stage_ms_eager=eager[3], launches=launches)
    log("kernels vs plain end to end:", res)
    within_limits("the kernel plan", res)
    if res["latent_std"] == 0.0:
        raise AssertionError("seeded-weight edit gave constant latents")
    before = launch_counts()
    faults = {kind: differ(run(kind, plain_versions=True), plain)
              for kind in ("attention", "conv")}
    if launch_counts() != before:
        raise AssertionError("a plain-version edit launched a kernel")
    log("planted faults, plain edits against the plain edit:", faults)
    conv_fault = faults["conv"]
    if (conv_fault["latent_rel_l2"] <= E2E_LATENT_REL_L2
            or conv_fault["image_mean_abs_lsb"] <= E2E_IMAGE_MEAN_LSB):
        raise AssertionError(
            f"the end-to-end tolerance passes a planted conv fault: {conv_fault}")
    torch.cuda.synchronize()
    return dict(default=res, planted_faults=faults)


# ------------------------------------------------------------------ phase 5


def graphs_vs_eager(editor) -> dict:
    """Graphs against the eager arm, bit for bit, on the seeded weights of
    phase 4."""
    from fastedit_tpu_torch.ops import flags

    images, prompts = [test_image(6), test_image(7)], ["a red barn", "a lake at dawn"]
    out = {}

    def n_keys():  # a new prompt may capture a prompt graph: count the edit's keys
        return len(editor._graphs.edit_keys())

    def pair(what, imgs, prm, **kw):
        graph = edit_arrays(editor, imgs, prm, **kw)
        with flags.override(cuda_graphs=False):
            eager = edit_arrays(editor, imgs, prm, **kw)
        same_bits(what, graph, eager)
        out[what] = dict(seconds_graphs=graph[2], seconds_eager=eager[2],
                         stage_ms_graphs=graph[3], stage_ms_eager=eager[3],
                         keys=n_keys(), image_std=float(graph[0].std()))
        log(f"graphs = eager, {what}:", out[what])

    pair("batch 1, CFG", images[:1], prompts[:1], seed=21, **EDIT_KW)
    pair("batch 1, no CFG", images[:1], prompts[:1], seed=22,
         **{**EDIT_KW, "guidance_scale": 1.0})
    pair("edit_batch of 2", images, prompts, seed=23, **EDIT_KW)
    keys = n_keys()
    # the batch-1 CFG key again: another image, prompt, seed, schedule (5 steps at
    # strength 0.6 run 3, from t = 599) and scales
    pair("batch 1, CFG, a second replay on new inputs", [test_image(8)], ["a desert road"],
         seed=24, strength=0.6, num_inference_steps=5, guidance_scale=2.0,
         controlnet_conditioning_scale=0.8)
    if n_keys() != keys:
        raise AssertionError("new inputs of a captured key captured another key")
    out["thresholds"] = thresholds_on_one_key(editor)
    return out


def thresholds_on_one_key(editor) -> dict:
    """One key replayed with each pair of ``CANNY_THRESHOLDS``: the control
    image its prepare graph wrote equals ``canny_np``'s edges at that pair,
    the final latents and images equal the eager arm's, and no key is
    captured."""
    import numpy as np

    from fastedit_tpu_torch.ops import canny, flags
    from fastedit_tpu_torch.pipeline import graphs

    image = test_image(9)
    arr = np.asarray(image)
    keys = len(editor._graphs.edit_keys())
    res = {}
    for low, high in CANNY_THRESHOLDS:
        kw = dict(seed=26, canny_low_threshold=low, canny_high_threshold=high, **EDIT_KW)
        graph = edit_arrays(editor, [image], ["a harbor"], **kw)
        key = graphs.graph_key(1, True, 3, False, RESOLUTION)
        control = editor._graphs.captured[key].prepared["control"]
        got = (control[0, ..., 0] > 0).cpu().numpy().astype(np.uint8) * 255
        ref = canny.canny_np(arr, low, high)
        if not np.array_equal(got, ref):
            raise AssertionError(f"the prepare graph at ({low}, {high}) differs from canny_np "
                                 f"in {int((got != ref).sum())} pixels")
        with flags.override(cuda_graphs=False):
            eager = edit_arrays(editor, [image], ["a harbor"], **kw)
        same_bits(f"thresholds ({low}, {high})", graph, eager)
        res[f"{low},{high}"] = dict(edge_pixels=int((ref > 0).sum()),
                                    prepare_ms_graph=graph[3]["prepare"],
                                    prepare_ms_eager=eager[3]["prepare"])
    if len(editor._graphs.edit_keys()) != keys:
        raise AssertionError("new thresholds captured another key")
    log("[5] one key, three threshold pairs, each equal to canny_np and the eager arm:", res)
    return res


def encode_anew(editor, prompts: list, on_graphs: bool = True) -> list:
    """``prompts`` encoded anew (dropped from the cache first) on the prompt
    graph or the eager arm: copies of their cached (context, pooled) rows."""
    from fastedit_tpu_torch.ops import flags

    for p in prompts:
        editor._prompt_cache.pop(p, None)
    with flags.override(cuda_graphs=on_graphs):
        editor._encode_prompts(prompts)
    return [tuple(t.clone() for t in editor._prompt_cache[p]) for p in prompts]


def prompt_graph_vs_eager(editor) -> dict:
    """The prompt graph against the eager arm, bit for bit, on the seeded
    weights: 1, 3 and 5 novel prompts (padded counts 1, 4 and 8); a cached
    row of prompt A unchanged after prompt B replayed the same key; the
    memory the prompt captures hold (pool growth, static buffers)."""
    import torch

    from fastedit_tpu_torch.pipeline import graphs

    out = {}
    for n in (1, 3, 5):
        prompts = [f"a prompt graph check, {n} prompts, {i}" for i in range(n)]
        graph, eager = encode_anew(editor, prompts), encode_anew(editor, prompts, False)
        if not all(torch.equal(a, b) for g, e in zip(graph, eager) for a, b in zip(g, e)):
            raise AssertionError(f"prompt graph and the eager arm differ at {n} prompts")
        padded = 1 << (n - 1).bit_length()
        if graphs.prompt_key(padded) not in editor._graphs.captured:
            raise AssertionError(f"{n} prompts: no prompt graph of {padded} captured")
        if float(graph[0][0].float().std()) == 0.0:
            raise AssertionError("seeded text encoders gave a constant context")
        out[f"novel_{n}"] = dict(padded=padded, same_bits=True)
    a = encode_anew(editor, ["a cached prompt, a"])[0]
    b = encode_anew(editor, ["a cached prompt, b"])[0]
    cached = editor._prompt_cache["a cached prompt, a"]
    if not (all(torch.equal(x, y) for x, y in zip(cached, a)) and not torch.equal(a[0], b[0])):
        raise AssertionError("a cached prompt changed when a later prompt replayed its graph")
    caps = {k: c for k, c in editor._graphs.captured.items()
            if isinstance(c, graphs.PromptCaptured)}
    out["pool_gib_by_padded_count"] = {k[1]: c.pool_bytes / 2**30 for k, c in caps.items()}
    out["static_gib"] = sum(t.numel() * t.element_size() for c in caps.values()
                            for t in (*c.ids, c.context, c.pooled)) / 2**30
    log("[5] prompt graph = eager arm bit for bit at 1, 3 and 5 prompts; a cached row kept:", out)
    return out


def graph_memory_sweep(editor, keys: int = 6) -> dict:
    """The graph cache's memory rule (``pipeline/graphs.py``) on the card:
    with ``MEMORY_BUDGET`` patched to what the card has in use now plus the
    rule's margin (the largest capture so far) and 0.1 GiB, ``keys`` new keys
    (4 to 9 run steps at strength 1.0, no CFG; phases 3-5 captured 5) must
    evict older ones, leave the card's memory in use within the budget after
    every capture and still give valid images.  All captures share one pool,
    on one side stream, so a new key of a captured size costs its static
    buffers (~0.05 GiB); the reserved bytes after each capture and their peak
    are printed."""
    import torch

    from fastedit_tpu_torch.pipeline import graphs

    eg = editor._graphs
    device = editor.device
    largest = max(c.pool_bytes for c in eg.captured.values())
    before = list(eg.captured)
    in_use, total = graphs._card_memory(device)  # after empty_cache
    budget = (in_use + largest + 0.1 * 2**30) / total
    saved = graphs.MEMORY_BUDGET
    res = dict(budget_share=budget, budget_gib=budget * total / 2**30,
               largest_pool_gib=largest / 2**30, in_use_gib_before=in_use / 2**30,
               reserved_gib_before=torch.cuda.memory_reserved(device) / 2**30,
               keys_before=len(eg.captured), in_use_gib=[], reserved_gib=[], keys_kept=[])
    torch.cuda.reset_peak_memory_stats(device)
    graphs.MEMORY_BUDGET = budget
    try:
        for steps in range(4, 4 + keys):
            out = editor.edit(test_image(9), "a harbor at noon", seed=30 + steps, strength=1.0,
                              num_inference_steps=steps, guidance_scale=1.0)
            check_image(out)
            res["reserved_gib"].append(torch.cuda.memory_reserved(device) / 2**30)
            used, _ = graphs._card_memory(device)
            res["in_use_gib"].append(used / 2**30)
            res["keys_kept"].append(len(eg.captured))
            if used > budget * total:
                raise AssertionError(f"graph cache: {used / 2**30:.3f} GiB in use after a "
                                     f"capture, over the budget of {budget * total / 2**30:.3f}")
    finally:
        graphs.MEMORY_BUDGET = saved
    res["peak_reserved_gib"] = torch.cuda.max_memory_reserved(device) / 2**30
    res["evicted"] = sum(k not in eg.captured for k in before)  # the oldest go first
    log("[5] graph cache under a patched memory budget:", res)
    if res["evicted"] < 1:
        raise AssertionError(f"graph cache: {keys} new keys under a budget of one more capture "
                             "evicted none of the keys before them")
    return res


# ----------------------------------------------------------------- phase 11


def tensor_parallel(editor, card: str, f32: bool = False, kept: dict | None = None) -> dict:
    """Phase 11: tensor parallelism on one card, on the seeded editor of
    phases 3-5 (bf16, 1024²) or, with ``f32``, on phase 8's seeded fp32
    editor (its fp32 arm): ``enable_data_parallel(["cuda:0", "cuda:0"],
    model_parallel=2)``, the UNet's and the ControlNet's transformer linears
    split in two on the one card (``parallel/tp.py``), an ``edit_batch`` of
    two images on the kernels and the graphs, under the caller's flags as
    any replica, against the same edit without TP, within phase 4's limits
    (fp32: phase 8's); the replica must have captured its graphs and
    launched the flash attention, conv, GroupNorm and Canny kernels (the
    counts of its warm-up and capture; fp32: their ``_f32`` instances);
    seconds per edit and the peak memory.  With ``kept`` (bf16), the same
    group's edit eagerly as well (``cuda_graphs=False``: its seconds and
    peak memory; the same bits as the graphs'), and ``kept`` receives the
    eager edit's and the edit without TP's (images, latents) for the arm
    across processes."""
    import numpy as np
    import torch

    from fastedit_tpu_torch.ops import flags
    from fastedit_tpu_torch.parallel import tp
    from fastedit_tpu_torch.tools.inventory import launch_counts, reset_launch_counts

    res: dict = {}
    t_phase = time.perf_counter()
    images, prompts = tp_images(), list(TP_PROMPTS)
    kw = dict(seed=TP_SEED, **EDIT_KW)
    edit_arrays(editor, images, prompts, **kw)  # the key's capture
    ref = edit_arrays(editor, images, prompts, **kw)
    res["without_tp_s"] = ref[2]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    group = editor.enable_data_parallel(["cuda:0", "cuda:0"], model_parallel=2)
    res["group_build_s"] = time.perf_counter() - t
    try:
        if group.shape != {"data": 1, "model": 2}:
            raise AssertionError(f"the TP group's shape is {group.shape}")
        replica = group.replicas[0]
        split = sum(isinstance(m, (tp.TPAttention, tp.TPFeedForward))
                    for name in ("unet", "controlnet")
                    for m in getattr(replica.modules, name).modules())
        seconds, outs = [], None
        reset_launch_counts()
        for _ in range(3):
            t = time.perf_counter()
            outs = editor.edit_batch(images, prompts, **kw)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t)
        got = (np.stack([np.asarray(o) for o in outs]), replica.last_latents.clone())
        res.update(differ(got, ref), split_modules=split, seconds_per_edit_batch2=seconds,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   captured_keys=len(replica._graphs.edit_keys()) if replica._graphs else 0,
                   launches={k: v for k, v in launch_counts().items() if v})
        if kept is not None:
            torch.cuda.reset_peak_memory_stats()
            eager_s = []
            with flags.override(cuda_graphs=False):
                for _ in range(2):
                    t = time.perf_counter()
                    outs = editor.edit_batch(images, prompts, **kw)
                    torch.cuda.synchronize()
                    eager_s.append(time.perf_counter() - t)
            eager = (np.stack([np.asarray(o) for o in outs]), replica.last_latents.clone())
            res.update(eager_seconds_per_edit_batch2=eager_s,
                       eager_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            same_bits("the TP group on one card", got, eager)
            kept.update(eager=(eager[0], eager[1].cpu()), without_tp=(ref[0], ref[1].cpu()))
    finally:
        editor._group = None
        del group
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[11] tensor parallelism x2 on one card{' (fp32)' if f32 else ''}: {res}; {card}")
    if not split:
        raise AssertionError("the TP replica split no module")
    sfx = "_f32" if f32 else ""
    not_launched = {k + sfx for k in TP_KERNELS} - set(res["launches"])
    if res["captured_keys"] != 1 or not_launched:
        raise AssertionError(f"the TP replica on one card captured {res['captured_keys']} keys "
                             f"(1 expected) and launched none of {sorted(not_launched)}")
    if f32 and set(res["launches"]) != {k for k in res["launches"] if k.endswith("_f32")}:
        raise AssertionError(f"the fp32 TP replica launched bf16 kernels: {res['launches']}")
    rel, lsb = (F32_E2E_LATENT_REL_L2, F32_E2E_IMAGE_MEAN_LSB) if f32 else (
        E2E_LATENT_REL_L2, E2E_IMAGE_MEAN_LSB)
    if res["latent_rel_l2"] > rel or res["image_mean_abs_lsb"] > lsb:
        raise AssertionError(f"the TP edit differs from the edit without TP beyond the limits "
                             f"(latents rel L2 <= {rel}, image mean <= {lsb} LSB): {res}")
    return res


# Phase 11's edit: an edit_batch of two at 1024², seed 31 (EDIT_KW: 4 steps at
# strength 0.8, 3 run, CFG 1.5), and the kernels each arm must launch.
TP_PROMPTS = ("a stone bridge", "a foggy forest")
TP_SEED = 31
TP_KERNELS = ("flash_attention_d64", "conv3x3", "group_norm", "canny_prepare")


def tp_images() -> list:
    return [test_image(90), test_image(91)]


# What each process of the arm across processes hands to its group's
# all-gathers per edit_batch of two (CFG: 4 rows through the UNet), per UNet
# call: SSD-1B's 26 transformer blocks at 32² tokens x 1280 channels and 8 at
# 64² x 640, three row-parallel layers a block (both attentions' to_out.0 and
# ff.net.2), one bf16 partial each (the small ControlNet has no transformer
# block); 3 steps.
TP_BYTES_PER_EDIT_BATCH = 3 * (78 * 4 * 32**2 * 1280 * 2 + 24 * 4 * 64**2 * 640 * 2)
assert TP_BYTES_PER_EDIT_BATCH == 3_963_617_280
TP_PROCESSES_REPS = 2
TP_PROCESSES_TIMEOUT_S = 420


def tensor_parallel_across_processes(card: str, in_process: dict, kept: dict) -> dict:
    """Phase 11's arm across processes: ``python -m
    fastedit_tpu_torch.tools.multihost_dryrun`` on the card, two processes
    joined over gloo, each with ``cuda:0`` as its one device, as one
    tensor-parallel group of two (each process holds one shard, the partials
    pass through pinned host memory and gloo), SSD-1B at 1024² in bf16 with
    the seeded weights of phase 4 (``--init_seed``), phase 11's
    ``edit_batch`` of two images and seed, ``TP_PROCESSES_REPS`` times.  The
    tool holds each worker's owned rows bit for bit against its own
    one-process recompute (the in-process group, eager), every row computed
    alike by both, and each worker's bytes against its reckoning; here, the
    owner's rows against this process's in-process group run eagerly
    (``kept["eager"]``: the max difference, predicted 0), against the edit
    without TP within phase 4's limits, each process's bytes per
    ``edit_batch`` against ``TP_BYTES_PER_EDIT_BATCH``, and the flash
    attention, conv, GroupNorm and Canny kernels launched in each.  The
    tool runs in a session of its own under ``TP_PROCESSES_TIMEOUT_S``: past
    it the session is killed and the phase fails, as it does on any
    worker's failure (the tool's exit code)."""
    import signal

    import numpy as np
    import torch

    work = ROOT / "build" / "chip_smoke_tp_processes"
    shutil.rmtree(work, ignore_errors=True)
    (work / "out").mkdir(parents=True)
    np.save(work / "images.npy", np.stack([np.asarray(im) for im in tp_images()]))
    argv = [sys.executable, "-m", "fastedit_tpu_torch.tools.multihost_dryrun",
            "--device", "cuda", "--model", "ssd-1b", "--dtype", "bf16", "--processes", "2",
            "--local_devices", "1", "--model_parallel", "2", "--batch", "2",
            "--images", str(work / "images.npy"), "--prompts", *TP_PROMPTS,
            "--seed", str(TP_SEED), "--init_seed", str(WEIGHT_SEED),
            "--reps", str(TP_PROCESSES_REPS), "--timeout", str(TP_PROCESSES_TIMEOUT_S - 30),
            "--out", str(work / "out")]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved() / 2**30
    t = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=TP_PROCESSES_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    wall = time.perf_counter() - t
    log_file = OUT_FILE.with_name("chip_smoke_tp_processes.log")
    log_file.parent.mkdir(parents=True, exist_ok=True)
    log_file.write_text(out)
    for line in out.splitlines():
        if line.startswith("[multihost_dryrun]"):
            log("  " + line)
    if proc.returncode != 0:
        raise AssertionError(f"tools/multihost_dryrun.py exited {proc.returncode} after "
                             f"{wall:.1f} s (limit {TP_PROCESSES_TIMEOUT_S} s); "
                             f"{log_file.relative_to(ROOT)}:\n{out[-3000:]}")
    ranks = [json.loads((work / "out" / f"rank{r}.json").read_text()) for r in range(2)]
    rows = np.load(work / "out" / "rank0_rows.npz")
    owner = (rows["images"], torch.from_numpy(rows["latents"]))
    eager_img, eager_lat = kept["eager"]
    res = dict(
        card=card, seconds=wall, memory_reserved_here_gib=reserved,
        per_process=[{key: r.get(key) for key in (
            "rank", "owned_rows", "computed_rows", "seconds_per_edit_batch", "peak_gib",
            "bytes_sent", "bytes_reckoned", "stage_s", "exchange_s", "group_build_s",
            "one_process_s", "without_tp_s",
            "one_process_max_abs", "launches")} for r in ranks],
        vs_in_process_eager=dict(
            image_max_abs_lsb=int(np.abs(owner[0].astype(np.int32)
                                         - eager_img.astype(np.int32)).max()),
            latent_max_abs=float((owner[1] - eager_lat.float()).abs().max())),
        vs_without_tp=differ(owner, kept["without_tp"]),
        in_process=dict(seconds_per_edit_batch2=in_process["seconds_per_edit_batch2"],
                        eager_seconds_per_edit_batch2=in_process[
                            "eager_seconds_per_edit_batch2"],
                        peak_gib=in_process["peak_gib"],
                        eager_peak_gib=in_process["eager_peak_gib"]),
        bytes_per_edit_batch_reckoned=TP_BYTES_PER_EDIT_BATCH)
    for p in res["per_process"]:
        p["bytes_per_edit_batch"] = p["bytes_sent"] / TP_PROCESSES_REPS
    log(f"[11] tensor parallelism x2 across two processes on one card: {res}; {card}")
    if [r["owned_rows"] for r in ranks] != [[0, 1], []]:
        raise AssertionError(f"rows owned: {[r['owned_rows'] for r in ranks]}, expected rank 0 "
                             "to own both")
    for p in res["per_process"]:
        if p["bytes_per_edit_batch"] != TP_BYTES_PER_EDIT_BATCH:
            raise AssertionError(f"rank {p['rank']} sent {p['bytes_per_edit_batch']} bytes per "
                                 f"edit_batch, the configuration reckons "
                                 f"{TP_BYTES_PER_EDIT_BATCH}")
        missing = set(TP_KERNELS) - set(p["launches"])
        if missing:
            raise AssertionError(f"rank {p['rank']} launched none of {sorted(missing)}")
    near = res["vs_without_tp"]
    if near["latent_rel_l2"] > E2E_LATENT_REL_L2 or near["image_mean_abs_lsb"] > E2E_IMAGE_MEAN_LSB:
        raise AssertionError(f"the edit across processes differs from the edit without TP "
                             f"beyond phase 4's limits: {near}")
    shutil.rmtree(work, ignore_errors=True)
    return res


# ------------------------------------------------------------------ phase 6

# SSD-1B's five models as a diffusers / transformers snapshot: component ->
# (its file's name, the converter's --expect name or None).
SNAPSHOT = {
    "unet": ("diffusion_pytorch_model.fp16.safetensors", "ssd-1b"),
    "controlnet": ("diffusion_pytorch_model.fp16.safetensors", "controlnet-small"),
    "vae": ("diffusion_pytorch_model.fp16.safetensors", "vae"),
    "text_encoder": ("model.fp16.safetensors", None),
    "text_encoder_2": ("model.fp16.safetensors", None),
}
LORA_RANK, LORA_ALPHA = 64, 32.0
LORA_PROJECTIONS = (".to_q", ".to_k", ".to_v", ".to_out.0")
# calculate_all_metrics_batch against the per-pair calls (the JAX package's
# own test of the batch: tests/test_metrics_batch.py)
METRICS_BATCH_RTOL, METRICS_BATCH_ATOL = 2e-4, 2e-5


def snapshot_configs() -> dict:
    """The public ``config.json`` of each SSD-1B component (the port's
    vendored copies)."""
    from fastedit_tpu_torch.tools import hf_vendored as V

    return {"unet": V.SSD1B_UNET_CONFIG, "controlnet": V.CONTROLNET_SMALL_CONFIG,
            "vae": V.VAE_CONFIG, "text_encoder": V.CLIP_VIT_L_TEXT_CONFIG,
            "text_encoder_2": V.CLIP_BIGG_TEXT_CONFIG}


def write_hf_snapshot(mod, out: Path, configs: dict, dtype) -> int:
    """Each model of ``mod`` (``PipelineModules``' five) as an HF snapshot
    component under ``out``: ``config.json`` from ``configs`` and its state
    dict (diffusers / transformers names) in ``dtype``, written by the port's
    safetensors writer.  Returns the bytes written."""
    from fastedit_tpu_torch.utils.safetensors_io import save_file

    nbytes = 0
    for name, (filename, _) in SNAPSHOT.items():
        path = out / name
        path.mkdir(parents=True)
        (path / "config.json").write_text(json.dumps(configs[name], indent=2))
        sd = {k: v.to(dtype) for k, v in getattr(mod, name).state_dict().items()}
        save_file(sd, str(path / filename))
        nbytes += (path / filename).stat().st_size
    return nbytes


def write_tokenizer(path: Path, vocab_size: int = 49408) -> None:
    """A small CLIP BPE vocabulary: the byte-level alphabet, each symbol
    also word-final, a few merges, and ``<|startoftext|>`` /
    ``<|endoftext|>`` as the last two ids (49406 / 49407 at CLIP's size)."""
    from fastedit_tpu_torch.text.tokenizer import bytes_to_unicode

    chars = list(bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    vocab.update({c + "</w>": len(chars) + i for i, c in enumerate(chars)})
    merges = [("t", "h"), ("th", "e</w>"), ("a", "n"), ("an", "d</w>"), ("i", "n"),
              ("o", "f</w>"), ("e", "r</w>"), ("a", "t</w>")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = vocab_size - 2, vocab_size - 1
    path.mkdir(parents=True, exist_ok=True)
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))


def kohya_lora(unet, seed: int, rank: int = LORA_RANK, alpha: float = LORA_ALPHA) -> dict:
    """A seeded rank-``rank`` LoRA over every attention projection of
    ``unet`` in the kohya dialect (``lora_unet_<module>.lora_down.weight``,
    ``.lora_up.weight``, ``.alpha``), fp32 on the host; the fused update
    alpha / rank * up @ down moves a weight by ~10% of its RMS."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, m in unet.named_modules():
        if not name.endswith(LORA_PROJECTIONS):
            continue
        n_out, n_in = m.weight.shape
        key = "lora_unet_" + name.replace(".", "_")
        out[f"{key}.lora_down.weight"] = torch.randn((rank, n_in), generator=gen) * n_in**-0.5
        out[f"{key}.lora_up.weight"] = torch.randn((n_out, rank), generator=gen) * (
            0.1 * rank / alpha * rank**-0.5)
        out[f"{key}.alpha"] = torch.tensor(alpha)
    return out


def fuse_lora_(unet, lora: dict) -> None:
    """The LoRA fused into ``unet``'s weights in place, in fp32 on the
    card: W = bf16(W + alpha / rank * up @ down)."""
    import torch

    with torch.no_grad():
        for name, m in unet.named_modules():
            if name.endswith(LORA_PROJECTIONS):
                m.weight.copy_(lora_reference(m.weight, lora, name))


def lora_reference(weight, lora: dict, module: str):
    """W + alpha / rank * up @ down in fp32 on ``weight``'s device."""
    key = "lora_unet_" + module.replace(".", "_")
    down = lora[f"{key}.lora_down.weight"].to(weight.device)
    up = lora[f"{key}.lora_up.weight"].to(weight.device)
    return weight.float() + float(lora[f"{key}.alpha"]) / down.shape[0] * (up @ down)


def convert_all(snap: Path, ckpt: Path, lora_file: Path, card: str) -> dict:
    """``python -m fastedit_tpu_torch.tools.convert_checkpoint`` on every
    component, the tokenizers, and the UNet again with the LoRA fused (into
    ``ckpt / "lora"``), all started together; each snapshot component is
    deleted once its conversions are done.  Returns seconds per conversion."""
    import shutil

    expect = {name: ["--expect", e] if e else [] for name, (_, e) in SNAPSHOT.items()}
    jobs = {name: [name, "--src", str(snap / name), "--out", str(ckpt / name), *expect[name]]
            for name in SNAPSHOT}
    jobs["unet+lora"] = ["unet", "--src", str(snap / "unet"), "--out",
                         str(ckpt / "lora" / "unet"), "--lora", str(lora_file), *expect["unet"]]
    for tok in ("tokenizer", "tokenizer_2"):
        jobs[tok] = ["tokenizer", "--src", str(snap / tok), "--out", str(ckpt / tok)]
    # one thread each (torch's and BLAS's): the jobs share the machine's cores, and a
    # job's copies and casts gain little from more threads than its own
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs, seconds, logs = {}, {}, {}
    deadline = time.perf_counter() + 600
    try:
        for name, args in jobs.items():
            logs[name] = ckpt.parent / f"convert_{name}.log"
            with open(logs[name], "w") as out:
                procs[name] = (time.perf_counter(), subprocess.Popen(
                    [sys.executable, "-m", "fastedit_tpu_torch.tools.convert_checkpoint", *args],
                    cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT))
        while len(seconds) < len(procs):  # each job's own seconds, as it ends
            if time.perf_counter() > deadline:
                raise AssertionError(f"conversions still running after 600 s: "
                                     f"{sorted(set(procs) - set(seconds))}")
            for name, (t0, proc) in procs.items():
                if name in seconds or proc.poll() is None:
                    continue
                seconds[name] = time.perf_counter() - t0
                if proc.returncode:
                    raise AssertionError(f"converting {name} failed ({proc.returncode}):\n"
                                         f"{logs[name].read_text()}")
                if name in SNAPSHOT and name != "unet":
                    shutil.rmtree(snap / name)
            time.sleep(0.05)
        shutil.rmtree(snap / "unet")
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, path in logs.items():
        log(f"  convert {name}: {seconds[name]:.2f} s; {card};",
            path.read_text().strip().splitlines()[-1])
    return seconds


def edit_one(editor, img, prompt: str, **kw):
    """One ``edit``: (uint8 image [1, r, r, 3], final latents, host seconds,
    device ms per stage)."""
    import numpy as np

    t = time.perf_counter()
    out = editor.edit(img, prompt, **kw)
    sec = time.perf_counter() - t
    lat = editor.last_latents.clone()
    if not bool(lat.isfinite().all()):
        raise AssertionError("non-finite final latents")
    return np.asarray(out)[None], lat, sec, editor.stage_ms()


def fp16_round_trip_(editor) -> None:
    """Every weight through bf16 -> fp16 -> bf16 (fp32 norms: fp32 -> fp16
    -> bf16 -> fp32), what the fp16 snapshot and its bf16 conversion do to
    it."""
    import torch

    mod = editor.modules
    with torch.no_grad():
        for name in SNAPSHOT:
            for p in getattr(mod, name).parameters():
                p.copy_(p.half().bfloat16())
    editor.clear_memory()


def checkpoint_and_metrics(editor, calls: dict, card: str, work: Path) -> dict:
    """Phase 6 on the seeded-weight SSD-1B editor of phases 4 and 5; its
    files under ``work`` (the converted checkpoint: ``work / "converted"``),
    which the caller removes."""
    import torch

    from fastedit_tpu_torch import FastEditor
    from fastedit_tpu_torch.text.tokenizer import CLIPTokenizer
    from fastedit_tpu_torch.tools import from_jax
    from fastedit_tpu_torch.tools.inventory import (
        launch_counts, launches_by_kernel, reset_launch_counts)
    from fastedit_tpu_torch.utils import checkpoint as ckpt_io
    from fastedit_tpu_torch.utils.safetensors_io import save_file

    snap, ckpt = work / "snapshot", work / "converted"
    res: dict = {}
    t = time.perf_counter()
    written = write_hf_snapshot(editor.modules, snap, snapshot_configs(), torch.float16)
    for tok in ("tokenizer", "tokenizer_2"):
        write_tokenizer(snap / tok)
    lora = kohya_lora(editor.modules.unet, seed=6)
    save_file(lora, str(work / "lora.safetensors"))
    res["snapshot_write_s"] = time.perf_counter() - t
    res["convert_s"] = convert_all(snap, ckpt, work / "lora.safetensors", card)
    written += sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
    res["gib_written"] = written / 1024**3
    for name in (*SNAPSHOT, "tokenizer", "tokenizer_2"):  # the LoRA checkpoint's others
        if name != "unet":
            (ckpt / "lora" / name).symlink_to(ckpt / name, target_is_directory=True)
    log(f"snapshot written in {res['snapshot_write_s']:.2f} s; {res['gib_written']:.2f} "
        f"GiB written in all (fp16 snapshot and bf16 conversions); {card}")

    t = time.perf_counter()
    loaded = FastEditor("ssd-1b", checkpoint_dir=str(ckpt))
    torch.cuda.synchronize()
    res["load_s"] = time.perf_counter() - t
    log(f"FastEditor('ssd-1b', checkpoint_dir=...) loaded in {res['load_s']:.2f} s; {card}")

    fp16_round_trip_(editor)  # nothing but I/O differs from the loaded editor now
    editor.tokenizer = CLIPTokenizer.from_dir(str(ckpt / "tokenizer"))
    editor.tokenizer_2 = CLIPTokenizer.from_dir(str(ckpt / "tokenizer_2"), pad_token_id=0)
    img, prompt = test_image(9), "the harbor and the boats at dusk"
    images, prompts = [test_image(10), test_image(11)], ["a street in the rain",
                                                         "an orchard in autumn"]
    runs = {"edit": lambda ed: edit_one(ed, img, prompt, seed=41, **EDIT_KW),
            "edit_batch of 2": lambda ed: edit_arrays(ed, images, prompts, seed=42,
                                                      **EDIT_KW)}
    per_edit = launches_by_kernel(calls["default_b1"])
    per_batch2 = launches_by_kernel(calls["default_b2"])
    reset_launch_counts()
    outs = {what: run(loaded) for what, run in runs.items()}
    check_launches("the loaded editor's first edit and edit_batch of 2 (an eager warm-up "
                   "and a capture each)", launch_counts(),
                   {k: 2 * (per_edit[k] + per_batch2[k]) for k in per_edit})
    for what, run in runs.items():
        got, ref = outs[what], run(editor)
        same_bits(f"loaded checkpoint against the in-memory editor, {what}", got, ref)
        res[what] = dict(seconds_loaded=got[2], seconds_in_memory=ref[2],
                         stage_ms_loaded=got[3], image_std=float(got[0].std()))
        log(f"loaded = in-memory bit for bit, {what}:", res[what])
    res["replay_launches"] = wrapper_launches(device_kernels(
        lambda: loaded.edit(img, prompt, seed=43, **EDIT_KW)))
    check_launches("one replayed edit of the loaded editor, device kernels by the profiler",
                   res["replay_launches"], {**per_edit, "up2_phase_weights": 0})
    del loaded
    torch.cuda.empty_cache()

    # LoRA: the fused tensors against W + alpha / rank * up @ down in fp32 on the card
    unet = editor.modules.unet
    fused_sd = from_jax.unet_state_dict(
        ckpt_io.load_params(str(ckpt / "lora" / "unet")), unet.cfg)
    worst, n_lora = 0.0, 0
    for name, m in unet.named_modules():
        if not name.endswith(LORA_PROJECTIONS):
            continue
        ref = lora_reference(m.weight, lora, name)
        got = fused_sd[f"{name}.weight"].to(ref.device)
        err, _ = check_close(f"LoRA-fused {name}", got, ref, CONV_REL, conv_tol(ref))
        if n_outside(m.weight, ref, CONV_REL, conv_tol(ref)) == 0:
            raise AssertionError(f"{name}: the tolerance passes the unfused weight")
        worst, n_lora = max(worst, err), n_lora + 1
    del fused_sd
    res["lora"] = dict(modules=n_lora, rank=LORA_RANK, alpha=LORA_ALPHA,
                       max_abs_err=worst)
    lora_editor = FastEditor("ssd-1b", checkpoint_dir=str(ckpt / "lora"))
    fuse_lora_(unet, lora)
    editor.clear_memory()
    got = edit_one(lora_editor, img, prompt, seed=44, **EDIT_KW)
    ref = edit_one(editor, img, prompt, seed=44, **EDIT_KW)
    res["lora"].update(differ(got, ref), against_unfused=differ(got, outs["edit"]))
    log("LoRA-fused checkpoint against the in-memory fuse:", res["lora"])
    if (res["lora"]["latent_rel_l2"] > E2E_LATENT_REL_L2
            or res["lora"]["image_mean_abs_lsb"] > E2E_IMAGE_MEAN_LSB):
        raise AssertionError(f"LoRA-fused checkpoint edit differs from the in-memory fuse "
                             f"beyond {E2E_LATENT_REL_L2} / {E2E_IMAGE_MEAN_LSB}: {res['lora']}")
    lora_image = got[0][0]
    del lora_editor
    torch.cuda.empty_cache()

    res["metrics"] = metrics_on_card(
        [img] + images + [test_image(12)],
        [outs["edit"][0][0], *outs["edit_batch of 2"][0], lora_image],
        [prompt, *prompts, "a lighthouse"], card)
    return res


def metrics_on_card(sources: list, edited_arrays: list, prompts: list, card: str) -> dict:
    """``MetricsCalculator(allow_random=True)`` at full width (CLIP ViT-B/16,
    DINO ViT-B/8, LPIPS-Squeeze at 512²) on four (source, edited, prompt)
    triples."""
    import math

    import torch
    from PIL import Image

    from fastedit_tpu_torch.metrics import MetricsCalculator

    edited = [Image.fromarray(a) for a in edited_arrays]
    t = time.perf_counter()
    calc = MetricsCalculator(weights_dir=str(ROOT / "build" / "no_metrics_weights"),
                             allow_random=True)
    res = dict(init_s=time.perf_counter() - t)
    if calc.device.type != "cuda" or calc.random_backbones != (
            "lpips", "clip_vision", "clip_text", "dino"):
        raise AssertionError(f"metrics on {calc.device}, random {calc.random_backbones}")
    calc.calculate_all_metrics(sources[0], edited[0], prompts[0])  # random weights made here
    torch.cuda.synchronize()
    t = time.perf_counter()
    pairs = [calc.calculate_all_metrics(s, e, p) for s, e, p in zip(sources, edited, prompts)]
    res["ms_per_pair"] = 1e3 * (time.perf_counter() - t) / len(pairs)
    calc.calculate_all_metrics_batch(sources, edited, prompts)
    t = time.perf_counter()
    batch = calc.calculate_all_metrics_batch(sources, edited, prompts)
    res["ms_per_batch_of_4"] = 1e3 * (time.perf_counter() - t)
    for i, (one, many) in enumerate(zip(pairs, batch, strict=True)):
        for k, v in one.items():
            if not math.isfinite(v):
                raise AssertionError(f"pair {i}: {k} = {v}")
            if abs(many[k] - v) > METRICS_BATCH_ATOL + METRICS_BATCH_RTOL * abs(v):
                raise AssertionError(f"pair {i}: {k} batched {many[k]} against {v}")
    same = dict(ssim=calc.calculate_ssim(sources[0], sources[0]),
                psnr=calc.calculate_psnr(sources[0], sources[0]),
                mse=calc.calculate_mse(sources[0], sources[0]))
    if same != dict(ssim=1.0, psnr=math.inf, mse=0.0):
        raise AssertionError(f"an image against itself: {same}")
    res.update(pairs=pairs, image_with_itself=same)
    log(f"metrics (random backbones at full width): {res['ms_per_pair']:.2f} ms per pair, "
        f"{res['ms_per_batch_of_4']:.2f} ms per batch of 4; {card}; first pair {pairs[0]}")
    del calc
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------------ phase 7


def cli(label: str, module, argv: list, echo: int = 12) -> tuple[int, str, float]:
    """``module.main(argv)`` in this process: (exit code, its standard
    output, wall seconds); the output's last ``echo`` lines are logged, all
    of it written to ``chiprun_out/chip_smoke_cli/<label>.log``."""
    import io

    buf = io.StringIO()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = module.main([str(a) for a in argv])
    finally:
        sec = time.perf_counter() - t
        out = buf.getvalue()
        (OUT_FILE.parent / "chip_smoke_cli").mkdir(parents=True, exist_ok=True)
        (OUT_FILE.parent / "chip_smoke_cli" / f"{label}.log").write_text(out)
    for line in [x for x in out.splitlines() if x.strip()][-echo:]:
        log(f"  | {line}")
    return rc, out, sec


def steady_s_per_image(out: str) -> float:
    """Seconds per image after the sweep's second image, from run_batch's
    progress lines (``..., 1.23 s``): the first edit's warm-up and capture
    left out."""
    times = [float(x.rsplit(", ", 1)[1].split()[0]) for x in out.splitlines()
             if x.startswith("Editing ") and x.endswith(" s")]
    return (times[-1] - times[1]) / (len(times) - 2)


def summary_count(out: str, what: str) -> int:
    """The count of a run_batch summary line (``Processed:  3 images``)."""
    lines = [x for x in out.splitlines() if x.startswith(f"{what}:")]
    if len(lines) != 1:
        raise AssertionError(f"no single '{what}:' line in run_batch's output")
    return int(lines[0].split()[1])


def summary_seconds(out: str, prefix: str) -> float:
    """The seconds a run_batch summary line starting with ``prefix`` gives."""
    line = next(x for x in out.splitlines() if x.startswith(prefix))
    return float(line.split(":")[-1].split("s")[0].split()[-1])


def decoded_images(root: Path) -> dict:
    """Every JPEG under ``root``, decoded: relative path -> uint8 array."""
    import numpy as np
    from PIL import Image

    return {str(p.relative_to(root)): np.asarray(Image.open(p))
            for p in sorted(root.rglob("*.jpg"))}


def same_images(what: str, got: dict, ref: dict) -> None:
    import numpy as np

    for rel, img in got.items():
        if rel not in ref or not np.array_equal(img, ref[rel]):
            raise AssertionError(f"{what}: {rel} differs from the sequential sweep's")


def same_figures(got: Path, ref: Path) -> None:
    """The comparison PNGs under ``got`` decode to those under ``ref``."""
    import numpy as np
    from PIL import Image

    names = sorted(str(p.relative_to(ref)) for p in ref.rglob("*.png"))
    if sorted(str(p.relative_to(got)) for p in got.rglob("*.png")) != names:
        raise AssertionError(f"comparison figures: {got} holds other files than {ref}")
    for rel in names:
        if not np.array_equal(np.asarray(Image.open(got / rel)), np.asarray(Image.open(ref / rel))):
            raise AssertionError(f"comparison figure {rel} differs from the sequential sweep's")


def keys_of_tree(tree) -> object:
    """A JSON tree's key structure: dicts of their keys' structures."""
    return {k: keys_of_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else None


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def clis_at_full_width(ckpt: Path, card: str) -> dict:
    """Phase 7: the port's entry points on the converted SSD-1B checkpoint
    at 1024², in this process but for the two-process sweep."""
    import csv
    import gc
    import math

    import torch
    from PIL import Image

    from fastedit_tpu_torch import evaluate, run_batch, run_benchmark, run_single_image
    from fastedit_tpu_torch.models import configs as C
    from fastedit_tpu_torch.tools import inventory, make_demo_data

    work = ROOT / "build" / "chip_smoke_cli"
    shutil.rmtree(work, ignore_errors=True)
    res: dict = {}
    t_phase = time.perf_counter()
    try:
        demo = work / "demo"
        make_demo_data.main(["--out", str(demo), "--n", "6", "--size", "512"])
        mapping = json.loads((demo / "mapping_file.json").read_text())
        data = ["--mapping_file", demo / "mapping_file.json",
                "--source_dir", demo / "annotation_images"]
        model = ["--model", "ssd-1b", "--checkpoint_dir", ckpt]

        # 7.2 one image, with the metrics and a trace
        first = demo / "annotation_images" / next(iter(mapping.values()))["image_path"]
        rc, out, sec = cli("run_single_image", run_single_image, [
            "--image", first, "--prompt", "a red square", *model, "--seed", 42,
            "--compute_metrics", "--profile", work / "trace", "--output_dir", work / "single"])
        edited = list((work / "single" / "single" / "edited" / "ssd-1b_fp16").glob("*"))
        jpgs = [p for p in edited if p.suffix == ".jpg"]
        metrics = [p for p in edited if p.name.startswith("metrics_")]
        traces = list((work / "trace").glob("*.json"))
        if rc != 0 or len(jpgs) != 1 or len(metrics) != 1 or len(traces) != 1:
            raise AssertionError(f"run_single_image: rc {rc}, files {edited}, traces {traces}")
        if Image.open(jpgs[0]).size != (RESOLUTION, RESOLUTION):
            raise AssertionError(f"run_single_image wrote a {Image.open(jpgs[0]).size} image")
        keys = [line.split(":")[0] for line in metrics[0].read_text().splitlines()]
        if keys[-6:] != ["ssim", "lpips", "psnr", "mse", "clip_score", "dino_distance"]:
            raise AssertionError(f"run_single_image's metrics file: {keys}")
        if traces[0].stat().st_size == 0:
            raise AssertionError("run_single_image wrote an empty trace")
        edit_s = float(next(line for line in metrics[0].read_text().splitlines()
                            if line.startswith("edit_seconds:")).split()[1])
        res["single"] = dict(cli_s=sec, traced_edit_s=edit_s,
                             trace_mib=traces[0].stat().st_size / 2**20)
        log(f"[7] run_single_image: {sec:.2f} s for the CLI (load, one edit, one traced edit, "
            f"metrics), the traced edit {edit_s:.2f} s, trace "
            f"{res['single']['trace_mib']:.1f} MiB; {card}")

        # 7.3 the sweep three times: sequential, data-parallel, resumed
        sweep = [*data, *model, "--steps", 4, "--guidance", 1.0, "--control_scale", 0.5,
                 "--seed", 42]
        per_edit = inventory.launches_by_kernel(inventory.kernel_calls(inventory.edit_sites(
            C.SSD1B_UNET, C.SDXL_CONTROLNET_SMALL, C.SDXL_VAE, RESOLUTION, batch=1, steps=3,
            cfg_guidance=False)))
        gc.collect()
        inventory.reset_launch_counts()
        rc, out, sec = cli("run_batch_sequential", run_batch,
                           [*sweep, "--save_comparisons", "--output_dir", work / "seq"])
        launches = inventory.launch_counts()
        if rc != 0 or summary_count(out, "Processed") != 6:
            raise AssertionError(f"sequential run_batch: rc {rc}")
        check_launches("run_batch's sequential sweep (one warm-up and one capture of its key)",
                       launches, {k: 2 * n for k, n in per_edit.items()})
        if not all(launches[k] for k in KERNELS):
            raise AssertionError(f"a kernel of the sweep's path never launched: {launches}")
        seq_root = work / "seq" / "batch" / "edited" / "ssd-1b_fp16"
        seq = decoded_images(seq_root)
        if len(seq) != 6 or any(a.shape != (RESOLUTION, RESOLUTION, 3) for a in seq.values()):
            raise AssertionError(f"sequential sweep: {[a.shape for a in seq.values()]}")
        if len(list((work / "seq" / "batch" / "comparisons").rglob("*.png"))) != 6:
            raise AssertionError("sequential sweep: not six comparison figures")
        res["sequential"] = dict(cli_s=sec, launches=launches,
                                 s_per_image=summary_seconds(out, "Total time") / 6,
                                 steady_s_per_image=steady_s_per_image(out))

        gc.collect()
        rc, out, sec = cli("run_batch_data_parallel", run_batch, [
            *sweep, "--save_comparisons", "--data_parallel", "--output_dir", work / "dp"])
        if rc != 0 or summary_count(out, "Processed") != 6:
            raise AssertionError(f"run_batch --data_parallel: rc {rc}")
        same_images("run_batch --data_parallel", decoded_images(
            work / "dp" / "batch" / "edited" / "ssd-1b_fp16"), seq)
        same_figures(work / "dp" / "batch" / "comparisons", work / "seq" / "batch" / "comparisons")
        res["data_parallel"] = dict(cli_s=sec, s_per_image=summary_seconds(
            out, "Sweep wall time") / 6, steady_s_per_image=steady_s_per_image(out))
        gc.collect()
        rc, out, sec = cli("run_batch_resumed", run_batch, [
            *sweep, "--save_comparisons", "--data_parallel", "--skip_existing",
            "--output_dir", work / "dp"])
        if rc != 0 or "Skipped:    6 images" not in out or summary_count(out, "Processed"):
            raise AssertionError("run_batch --data_parallel --skip_existing did not skip six")
        res["resumed_cli_s"] = sec
        seq_r, dp_r = res["sequential"], res["data_parallel"]
        log(f"[7] run_batch at 1024² (guidance 1, 3 steps run), s per image over the six by "
            f"the sweeps' own clocks (the first edit's warm-up and capture included): "
            f"sequential {seq_r['s_per_image']:.3f}, data-parallel {dp_r['s_per_image']:.3f}, "
            f"images per second {1 / seq_r['s_per_image']:.2f} and "
            f"{1 / dp_r['s_per_image']:.2f}; after the second image "
            f"{seq_r['steady_s_per_image']:.3f} and {dp_r['steady_s_per_image']:.3f} s per "
            f"image; CLI wall s {seq_r['cli_s']:.2f}, {dp_r['cli_s']:.2f}, {sec:.2f} "
            f"(resumed, nothing edited); {card}")

        # 7.4 two processes on the one card, joined over gloo, one output planted
        out_mh = work / "multihost"
        planted = out_mh / "batch" / "edited" / "ssd-1b_fp16" / next(
            iter(mapping.values()))["image_path"]
        planted.parent.mkdir(parents=True, exist_ok=True)
        planted.write_bytes(b"placeholder")
        port = free_port()
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        t = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "fastedit_tpu_torch.run_batch",
             *map(str, sweep), "--output_dir", str(out_mh), "--skip_existing",
             "--data_parallel", "--num_processes", "2", "--process_id", str(rank),
             "--coordinator_address", f"localhost:{port}"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(2)]
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        res["multihost_s"] = time.perf_counter() - t
        for rank, (p, o) in enumerate(zip(procs, outs)):
            for line in [x for x in o.splitlines() if x.strip()][-8:]:
                log(f"  | rank {rank}: {line}")
            if p.returncode != 0 or "Skipped:    1 images" not in o:
                raise AssertionError(f"rank {rank} of the two-process sweep: rc {p.returncode}")
        counts = sorted(summary_count(o, "Processed") for o in outs)
        if counts != [2, 3]:
            raise AssertionError(f"two-process sweep processed {counts}, expected [2, 3]")
        if planted.read_bytes() != b"placeholder":
            raise AssertionError("the two-process sweep wrote over the planted output")
        planted.unlink()
        got = decoded_images(out_mh / "batch" / "edited" / "ssd-1b_fp16")
        if len(got) != 5:
            raise AssertionError(f"two-process sweep saved {len(got)} images, expected 5")
        same_images("the two-process sweep", got, seq)
        log(f"[7] two run_batch processes on one card: {res['multihost_s']:.2f} s, processed "
            f"{counts}, five images bit for bit the sequential sweep's; {card}")

        # 7.5 evaluate the sequential sweep
        gc.collect()
        torch.cuda.empty_cache()
        rc, out, sec = cli("evaluate", evaluate, [
            *data, "--outputs_dir", seq_root, "--results_file", work / "eval" / "metrics.csv",
            "--summary_file", work / "eval" / "summary.json",
            "--metrics_weights", work / "no_metrics_weights", "--allow_random_metrics"])
        tiny = ROOT / "examples" / "tiny_results"
        with open(work / "eval" / "metrics.csv") as f:
            rows = list(csv.DictReader(f))
        with open(tiny / "metrics.csv") as f:
            columns = next(csv.reader(f))
        summary = json.loads((work / "eval" / "summary.json").read_text())
        if rc != 0 or len(rows) != 6 or list(rows[0]) != columns:
            raise AssertionError(f"evaluate: rc {rc}, {len(rows)} rows, columns {list(rows[0])}")
        if keys_of_tree(summary) != keys_of_tree(json.loads((tiny / "summary.json").read_text())):
            raise AssertionError("evaluate: summary.json's keys differ from the shipped example's")
        for row in rows:
            if not all(math.isfinite(float(row[m])) for m in columns[4:]):
                raise AssertionError(f"evaluate: a value is not finite: {row}")
        res["evaluate"] = dict(cli_s=sec, ms_per_pair=1e3 * sec / 6)
        log(f"[7] evaluate --allow_random_metrics: {res['evaluate']['ms_per_pair']:.1f} ms per "
            f"pair (the CLI's wall time over six pairs, the calculator's set-up included); "
            f"{card}")

        # 7.6 the whole chain on the demo set
        gc.collect()
        torch.cuda.empty_cache()
        bench_dir = work / "bench"
        bench_dir.mkdir()
        saved_env = {k: os.environ.get(k) for k in
                     ("PIEBENCH_DIR", "OUTPUT_DIR", "RESULTS_DIR", "FIGURES_DIR", "N_FIGURES")}
        os.environ.update(PIEBENCH_DIR=str(demo), OUTPUT_DIR=str(bench_dir / "outputs"),
                          RESULTS_DIR=str(bench_dir / "results"),
                          FIGURES_DIR=str(bench_dir / "figures"))
        os.environ.pop("N_FIGURES", None)
        try:
            os.chdir(bench_dir)  # the archive lands in the current directory
            rc, out, sec = cli("run_benchmark", run_benchmark,
                               ["ssd-1b", "--checkpoint_dir", ckpt])
        finally:
            os.chdir(ROOT)
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        with open(bench_dir / "results" / "ssd-1b_fp16" / "metrics.csv") as f:
            rows = list(csv.DictReader(f))
        figures = list((bench_dir / "figures").glob("comparison_*.png"))
        if (rc != 0 or len(rows) != 6 or len(figures) != 3
                or not (bench_dir / "results" / "ssd-1b_fp16" / "summary.json").is_file()
                or not (bench_dir / "results_ssd-1b_fp16.tar.gz").is_file()):
            raise AssertionError(f"run_benchmark: rc {rc}, {len(rows)} rows, {figures}")
        for row in rows:
            exact = [float(row[m]) for m in ("ssim", "psnr", "mse")]
            learned = [float(row[m]) for m in ("lpips", "clip_score", "dino_distance")]
            if not all(map(math.isfinite, exact)) or not all(map(math.isnan, learned)):
                raise AssertionError(f"run_benchmark's metrics.csv: {row}")
        res["run_benchmark_s"] = sec
        log(f"[7] run_benchmark ssd-1b: {sec:.2f} s (sweep, evaluation, three figures, "
            f"archive); {card}")

        # 7.7 fp32 on the checkpoint (cast as it loads), and quality mode, which must fail
        # only for the checkpoint's missing controlnet_full
        gc.collect()
        torch.cuda.empty_cache()
        inventory.reset_launch_counts()
        rc, out, sec = cli("run_single_image_full_precision", run_single_image, [
            "--image", first, "--prompt", "a red square", *model, "--seed", 42,
            "--full_precision", "--output_dir", work / "single_f32"])
        launches = inventory.launch_counts()
        jpgs = list((work / "single_f32" / "single" / "edited" / "ssd-1b_fp32").glob("*.jpg"))
        if rc != 0 or len(jpgs) != 1 or Image.open(jpgs[0]).size != (RESOLUTION, RESOLUTION):
            raise AssertionError(f"run_single_image --full_precision: rc {rc}, files {jpgs}")
        per_f32 = inventory.launches_by_kernel(inventory.kernel_calls(inventory.edit_sites(
            C.SSD1B_UNET, C.SDXL_CONTROLNET_SMALL, C.SDXL_VAE, RESOLUTION, batch=1, steps=3),
            dtype=torch.float32))
        check_launches("run_single_image --full_precision (one warm-up and one capture)",
                       launches, {k: 2 * n for k, n in per_f32.items()})
        res["single_full_precision_cli_s"] = sec
        gc.collect()
        torch.cuda.empty_cache()
        try:
            cli("run_single_image_quality_mode", run_single_image, [
                "--image", first, "--prompt", "a red square", *model, "--quality_mode",
                "--output_dir", work / "single_quality"])
            raise AssertionError("run_single_image --quality_mode ran without controlnet_full")
        except FileNotFoundError as e:
            if "controlnet_full" not in str(e):
                raise
            res["quality_mode_error"] = str(e).splitlines()[0]
        log(f"[7] run_single_image --full_precision: {sec:.2f} s for the CLI (load, a first "
            f"edit with its capture); --quality_mode refused as the reference refuses it: "
            f"{res['quality_mode_error'][:100]}; {card}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[7] phase 7 took {res['seconds']:.1f} s; {card}")
    return res


# ------------------------------------------------------------------ phase 8


def tf32_split_gib(editor) -> float:
    """GiB of the TF32 hi and lo weight copies that the conv modules keep for
    the fp32 kernels (``models/resnet._prepared``, one pair per weight, of the
    upsample convs' phase weights)."""
    mod, total = editor.modules, 0
    for model in (mod.unet, mod.controlnet, mod.vae, mod.text_encoder, mod.text_encoder_2):
        for m in model.modules():
            for name in ("tf32_split", "up2_tf32_split"):
                hit = m.__dict__.get("_prepared_cache", {}).get(name)
                if hit is not None:
                    total += sum(t.numel() * t.element_size() for t in hit[1])
    return total / 1024**3


def f32_prompt_graph_without_tf32(editor) -> dict:
    """With TF32 on in the process, the fp32 editor's prompt graph, captured
    here (outside an edit, as a warm-up encodes), equals its text encoders
    run with TF32 off, which TF32 would move."""
    import numpy as np
    import torch

    from fastedit_tpu_torch.pipeline import graphs, stages

    eg, prompts = editor._graphs, ["an fp32 prompt graph", "captured with tf32 allowed"]
    for key in [k for k, c in eg.captured.items() if isinstance(c, graphs.PromptCaptured)]:
        del eg.captured[key]
    backends = torch.backends
    saved = backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32
    try:
        backends.cuda.matmul.allow_tf32 = backends.cudnn.allow_tf32 = True
        ctx = torch.cat([rows[0] for rows in encode_anew(editor, prompts)])
        ids = [torch.from_numpy(np.stack([tok.encode(p) for p in prompts])).long().cuda()
               for tok in (editor.tokenizer, editor.tokenizer_2)]
        with_tf32 = stages.encode_prompt(editor.modules, *ids)[0]
        backends.cuda.matmul.allow_tf32 = backends.cudnn.allow_tf32 = False
        without = stages.encode_prompt(editor.modules, *ids)[0]
    finally:
        backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32 = saved
    res = dict(graph_equals_tf32_off=bool(torch.equal(ctx, without)),
               tf32_max_abs_diff=float((with_tf32 - without).abs().max()),
               graph_max_abs_diff=float((ctx - without).abs().max()))
    log("[8] the fp32 prompt graph captured with TF32 allowed in the process:", res)
    if not res["graph_equals_tf32_off"]:
        raise AssertionError(f"the fp32 prompt graph is not the TF32-off encode: {res}")
    if res["tf32_max_abs_diff"] == 0.0:
        raise AssertionError("TF32 does not move the fp32 text encoders: the check cannot see "
                             "a prompt graph captured in TF32")
    return res


def f32_path(calls: dict, card: str) -> dict:
    """Phase 8: the fp32 path (the reference's fp32 configuration and its
    quality mode) on the card, on graphs, with the bf16 editors freed."""
    import gc

    import numpy as np
    import torch

    from fastedit_tpu_torch import FastEditor
    from fastedit_tpu_torch.ops import flags
    from fastedit_tpu_torch.pipeline.graphs import STAGES
    from fastedit_tpu_torch.tools.inventory import (
        launch_counts, launches_by_kernel, reset_launch_counts)

    res: dict = {}
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    editor = FastEditor("ssd-1b", random_weights=True, use_full_precision=True)
    torch.cuda.synchronize()
    res["editor_build_s"] = time.perf_counter() - t0
    images = [test_image(1), test_image(2)]
    per_edit = launches_by_kernel(calls["f32_b1"])
    per_batch2 = launches_by_kernel(calls["f32_b2"])

    # 8.1 the main path: a warm-up, two edits, an edit_batch of two, on graphs
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    res["warmup_s"] = editor.warmup(**EDIT_KW)
    res["edits"] = []
    for i in range(2):
        t = time.perf_counter()
        out = editor.edit(images[0], "a watercolor painting of a harbor", seed=i, **EDIT_KW)
        res["edits"].append(dict(seconds=time.perf_counter() - t, stage_ms=editor.stage_ms()))
        check_image(out)
        log(f"[8] fp32 edit {i}: {res['edits'][-1]['seconds']:.4f} s",
            res["edits"][-1]["stage_ms"])
    t = time.perf_counter()
    outs = editor.edit_batch(images, ["a snowy street", "a city at night"], seed=3, **EDIT_KW)
    res["edit_batch2"] = dict(seconds=time.perf_counter() - t, stage_ms=editor.stage_ms())
    for out in outs:
        check_image(out)
    res["launches"] = launch_counts()
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 1024**3
    res["tf32_split_gib"] = tf32_split_gib(editor)
    keys = edit_captures(editor)
    if len(keys) != 2 or any(tuple(c.graphs) != STAGES for c in keys.values()):
        raise AssertionError(f"fp32: expected two keys of three graphs each, got {list(keys)}")
    res["graph_pool_gib"] = {str(k[:5]): c.pool_bytes / 1024**3 for k, c in keys.items()}
    check_launches("fp32: two keys' first calls (eager warm-up and capture each), then replays",
                   res["launches"], {k: 2 * (per_edit[k] + per_batch2[k]) for k in per_edit})
    res["replay_launches"] = wrapper_launches(device_kernels(
        lambda: editor.edit(images[0], "a watercolor painting of a harbor", seed=5, **EDIT_KW)))
    check_launches("fp32: one replayed edit, device kernels by the profiler",
                   res["replay_launches"], {**per_edit, "up2_phase_weights": 0})
    # guidance 1.0 (no CFG: the reference notebook's setting), a key of its own
    res["guidance1_edits"] = []
    for i in range(2):
        t = time.perf_counter()
        out = editor.edit(images[0], "a watercolor painting of a harbor", seed=10 + i,
                          **{**EDIT_KW, "guidance_scale": 1.0})
        res["guidance1_edits"].append(dict(seconds=time.perf_counter() - t,
                                           stage_ms=editor.stage_ms()))
        check_image(out)
    log(f"[8] fp32 edit at guidance 1.0: first call {res['guidance1_edits'][0]['seconds']:.3f} s, "
        f"replayed {res['guidance1_edits'][1]['seconds']:.4f} s",
        res["guidance1_edits"][1]["stage_ms"])
    log(f"[8] fp32 warm-up {res['warmup_s']:.2f} s, edit_batch of 2 (first call) "
        f"{res['edit_batch2']['seconds']:.2f} s, peak {res['peak_gib']:.3f} GiB (of it the "
        f"weights' TF32 hi and lo copies {res['tf32_split_gib']:.3f} GiB), pools "
        f"{res['graph_pool_gib']}; {card}")

    # 8.2 seeded weights: graphs = eager bit for bit, kernels against plain versions
    seeded_weights_(editor, seed=20261017)
    res["prompt_graph_tf32"] = f32_prompt_graph_without_tf32(editor)
    img, prompt = test_image(5), "an oil painting of a lighthouse"
    editor._encode_prompts([prompt, ""])

    def run(fault=None, **override):
        with flags.override(**override), (planted_fault(fault) if fault
                                          else contextlib.nullcontext()):
            return edit_arrays(editor, [img], [prompt], seed=11, **EDIT_KW)

    reset_launch_counts()
    kern = run()
    check_launches("fp32, seeded: one edit on graphs (a new key)", launch_counts(),
                   {k: 2 * n for k, n in per_edit.items()})
    reset_launch_counts()
    eager = run(cuda_graphs=False)
    check_launches("fp32, seeded: one edit on the eager arm", launch_counts(), per_edit)
    same_bits("fp32", kern, eager)
    before = launch_counts()
    plain = run(plain_versions=True)
    fault = run("conv_f32", plain_versions=True)
    if launch_counts() != before:
        raise AssertionError("an fp32 plain-version edit launched a kernel")
    res["kernels_vs_plain"] = dict(
        differ(kern, plain), latent_std=float(plain[1].float().std()),
        seconds_graphs_first_call=kern[2], seconds_eager=eager[2], seconds_plain=plain[2],
        stage_ms_graphs=kern[3], stage_ms_eager=eager[3])
    res["planted_conv_fault"] = differ(fault, plain)
    log("[8] fp32 kernels vs plain end to end:", res["kernels_vs_plain"])
    log("[8] fp32 planted conv fault (last Cin chunk skipped) vs plain:",
        res["planted_conv_fault"])
    log("[11] phase 11's fp32 arm: tensor parallelism on phase 8's seeded fp32 editor")
    res["tensor_parallel"] = tensor_parallel(editor, card, f32=True)
    e2e = res["kernels_vs_plain"]
    if (e2e["latent_rel_l2"] > F32_E2E_LATENT_REL_L2
            or e2e["image_mean_abs_lsb"] > F32_E2E_IMAGE_MEAN_LSB or e2e["latent_std"] == 0.0):
        raise AssertionError(f"fp32 kernel edit differs from the plain edit beyond "
                             f"{F32_E2E_LATENT_REL_L2} / {F32_E2E_IMAGE_MEAN_LSB}: {e2e}")
    bad = res["planted_conv_fault"]
    if (bad["latent_rel_l2"] <= F32_E2E_LATENT_REL_L2
            or bad["image_mean_abs_lsb"] <= F32_E2E_IMAGE_MEAN_LSB):
        raise AssertionError(f"the fp32 end-to-end tolerance passes a planted conv fault: {bad}")
    # one request through the fp32 service: the graphs' edit of the same input
    from fastedit_tpu_torch.serve import EditParams, EditService

    t = time.perf_counter()
    with EditService(editor, max_batch=4) as svc:
        served = np.asarray(svc.edit(img, prompt, EditParams(seed=11), timeout=600))
    res["service_request_s"] = time.perf_counter() - t
    if not np.array_equal(served, kern[0][0]):
        raise AssertionError("fp32 service: the served image differs from the editor's edit")
    log(f"[8] one fp32 request through EditService: {res['service_request_s']:.3f} s, the "
        "editor's own edit bit for bit")
    del editor, kern, eager, plain, fault
    gc.collect()
    torch.cuda.empty_cache()

    # 8.3 quality mode: fp32 and the full ControlNet
    quality = FastEditor("ssd-1b", random_weights=True, use_full_precision=True,
                         use_full_controlnet=True)
    reset_launch_counts()
    t = time.perf_counter()
    check_image(quality.edit(images[0], "a watercolor painting of a harbor", seed=7,
                             **EDIT_KW))
    res["quality_first_edit_s"] = time.perf_counter() - t
    t = time.perf_counter()
    check_image(quality.edit(images[1], "a snowy street", seed=8, **EDIT_KW))
    res["quality_edit"] = dict(seconds=time.perf_counter() - t, stage_ms=quality.stage_ms())
    res["quality_launches"] = launch_counts()
    check_launches("quality mode: one edit's warm-up and capture, then a replay",
                   res["quality_launches"],
                   {k: 2 * n for k, n in launches_by_kernel(calls["f32_quality_b1"]).items()})
    res["quality_peak_gib"] = torch.cuda.max_memory_allocated() / 1024**3
    log(f"[8] quality mode: first edit {res['quality_first_edit_s']:.2f} s, replayed edit "
        f"{res['quality_edit']['seconds']:.4f} s", res["quality_edit"]["stage_ms"])
    del quality
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[8] phase 8 took {res['seconds']:.1f} s; {card}")
    return res


# ------------------------------------------------------------------ phase 9

# The service's window for the lone requests and the burst (the CLI's
# default), and the one it is widened to for the cases that must coalesce:
# four 1024² requests sent at once from four threads reach ``submit`` some
# tens of ms apart (each body is decoded in its own handler thread).
SERVE_WINDOW_MS = 10.0
COALESCE_WINDOW_S = 1.0
# a request held behind two batches of four times out after this long
SHORT_TIMEOUT_S = 0.2


def request_body(img, prompt: str, **fields) -> tuple[dict, object]:
    """A ``POST /v1/edit`` body with ``img`` as a JPEG (quality 95), and the
    image the server decodes from it."""
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=95)
    decoded = Image.open(io.BytesIO(buf.getvalue())).convert("RGB")
    return {"image": base64.b64encode(buf.getvalue()).decode("ascii"), "prompt": prompt,
            **fields}, decoded


def http_call(port: int, method: str, path: str, body=None, timeout: float = 600.0):
    """(status, JSON reply, client seconds) of one request to localhost."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t = time.perf_counter()
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read()), time.perf_counter() - t
    finally:
        conn.close()


def concurrently(calls: list) -> list:
    """Run the zero-argument ``calls`` on threads of their own, all at once;
    their results in order."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(calls)) as pool:
        return list(pool.map(lambda call: call(), calls))


def posted_images(replies: list) -> list:
    """The uint8 images of 200 replies to ``POST /v1/edit``."""
    import base64
    import io

    import numpy as np
    from PIL import Image

    out = []
    for code, reply, _ in replies:
        if code != 200:
            raise AssertionError(f"edit request answered {code}: {reply}")
        img = np.asarray(Image.open(io.BytesIO(base64.b64decode(reply["image"]))).convert("RGB"))
        check_image(img)
        out.append(img)
    return out


def hist_delta(before: dict, after: dict) -> dict:
    """What a run of requests added to the service's ``batch_size_hist``."""
    a, b = after["batch_size_hist"], before["batch_size_hist"]
    return {k: v - b.get(k, 0) for k, v in a.items() if v != b.get(k, 0)}


def dispatch_split(since_ns: int) -> dict:
    """Where the dispatcher's calls of the editor since ``since_ns`` spent
    their host seconds: each ``serve.dispatch`` record's outermost facade
    and graphs spans (``utils/profiling.py``; a replay by its stage), and
    ``other``, the rest of the call."""
    import collections

    from fastedit_tpu_torch.utils import profiling

    recs = profiling.records(since_ns=since_ns)
    out = collections.defaultdict(float)
    for d in (r for r in recs if r.name == "serve.dispatch"):
        mine = [r for r in recs if r.thread == d.thread and d.t0_ns <= r.t0_ns
                and r.t1_ns <= d.t1_ns and r.name.startswith(("facade.", "graphs."))]
        top = [r for r in mine if not any(o is not r and o.t0_ns <= r.t0_ns and r.t1_ns <= o.t1_ns
                                          for o in mine)]
        for r in top:
            name = r.name + (f"[{r.ids['stage']}]" if "stage" in r.ids else "")
            out[name] += (r.t1_ns - r.t0_ns) / 1e9
        out["other"] += (d.t1_ns - d.t0_ns - sum(r.t1_ns - r.t0_ns for r in top)) / 1e9
    return dict(out)


def serving(editor, card: str) -> dict:
    """Phase 9: ``serve.EditService`` and its HTTP front-end on the SSD-1B
    editor of phases 3-5 (seeded weights), bf16 at 1024², default flags."""
    import statistics
    import threading

    import numpy as np
    import torch

    from fastedit_tpu_torch.models import configs as C
    from fastedit_tpu_torch.pipeline import graphs
    from fastedit_tpu_torch.serve import EditService, make_http_server
    from fastedit_tpu_torch.tools import inventory
    from fastedit_tpu_torch.tools.inventory import launch_counts, reset_launch_counts

    res: dict = {}
    t_phase = time.perf_counter()
    editor._graphs.clear()  # every key this phase serves is captured in it
    torch.cuda.empty_cache()
    reset_launch_counts()
    svc = EditService(editor, max_batch=4, batch_window_ms=SERVE_WINDOW_MS)
    # warmup((1, 2, 4)), one size at a time: each key's capture seconds and the
    # card's memory in use after it
    res["warmup"] = []
    for b in (1, 2, 4):
        seconds = svc.warmup((b,))
        res["warmup"].append(dict(batch=b, seconds=seconds,
                                  in_use_gib=graphs._card_memory(editor.device)[0] / 2**30,
                                  allocated_gib=torch.cuda.memory_allocated() / 2**30,
                                  reserved_gib=torch.cuda.memory_reserved() / 2**30))
    res["warmup_s"] = sum(w["seconds"] for w in res["warmup"])
    log(f"[9] warmup((1, 2, 4)) {res['warmup_s']:.2f} s:", res["warmup"])

    servers = []

    def serve_on(service, timeout_s=600.0):
        httpd = make_http_server(service, port=0, request_timeout_s=timeout_s)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        servers.append(httpd)
        return httpd.server_address[1]

    futures = []  # (prompt, future) of every request the service took
    submit = svc.submit

    def recording_submit(image, prompt, params=None):
        futures.append((prompt, submit(image, prompt, params)))
        return futures[-1][1]

    svc.submit = recording_submit
    port = serve_on(svc)
    try:
        # one request alone: a new prompt, then the same request (the prompt cached)
        lone = {"new_prompt": [], "cached_prompt": []}
        for i in range(3):
            body, _ = request_body(test_image(40 + i), f"a lone request {i}")
            for kind in lone:
                code, reply, sec = http_call(port, "POST", "/v1/edit", body)
                posted_images([(code, reply, sec)])
                lone[kind].append(dict(client_s=sec, server_ms=reply["latency_ms"]))
        res["lone"] = {k: dict(client_s=statistics.median(r["client_s"] for r in v),
                               server_ms=statistics.median(r["server_ms"] for r in v), runs=v)
                       for k, v in lone.items()}
        log("[9] one request alone (JPEG in and out, 1024²), medians of 3:",
            {k: (v["client_s"], v["server_ms"]) for k, v in res["lone"].items()})

        svc.batch_window_s = COALESCE_WINDOW_S
        # four at once, equal params, seed 7: one batch of four
        four = [request_body(test_image(50 + i), f"a batched request {i}", seed=7,
                             format="png") for i in range(4)]
        before = svc.stats()
        replies = concurrently([lambda b=b: http_call(port, "POST", "/v1/edit", b)
                                for b, _ in four])
        batched = posted_images(replies)
        # The batch's rows are in the order the requests reached the queue, which
        # the four client threads do not fix; the editor cached their new prompts
        # in that order.  The latents, copied now (the service is idle), in the
        # requests' order:
        prompts = [f"a batched request {i}" for i in range(4)]
        queued = list(editor._prompt_cache)[-4:]
        if sorted(queued) != prompts:
            raise AssertionError(f"the batch of four encoded {queued}, not {prompts}")
        batched_latents = editor.last_latents[[queued.index(p) for p in prompts]]
        res["four"] = dict(hist=hist_delta(before, svc.stats()), queued=queued,
                           client_s=[r[2] for r in replies])
        if res["four"]["hist"] != {"4": 1} or batched_latents.shape[0] != 4:
            raise AssertionError(f"four requests at once did not form one batch: {res['four']}")
        # three at once: padded to four, three images back
        before = svc.stats()
        replies = concurrently([lambda i=i: http_call(port, "POST", "/v1/edit", request_body(
            test_image(54 + i), f"a padded request {i}", seed=8)[0]) for i in range(3)])
        res["three"] = dict(hist=hist_delta(before, svc.stats()), images=len(posted_images(replies)))
        if res["three"] != dict(hist={"3": 1}, images=3):
            raise AssertionError(f"three requests at once: {res['three']}")
        # two that differ only in guidance: two batches
        before = svc.stats()
        replies = concurrently([lambda g=g: http_call(port, "POST", "/v1/edit", request_body(
            test_image(57), "a guidance request", seed=9, guidance_scale=g)[0])
            for g in (1.5, 2.0)])
        posted_images(replies)
        res["two_guidances"] = dict(hist=hist_delta(before, svc.stats()),
                                    batches=svc.stats()["batches"] - before["batches"])
        if res["two_guidances"] != dict(hist={"1": 2}, batches=2):
            raise AssertionError(f"two guidances shared a batch: {res['two_guidances']}")
        log("[9] coalescing:", {k: res[k] for k in ("four", "three", "two_guidances")})

        # a burst of 16 new prompts, equal params, at the serving window
        svc.batch_window_s = SERVE_WINDOW_MS / 1000
        bodies = [request_body(test_image(60 + i % 4), f"a burst request {i}")[0]
                  for i in range(16)]
        before = svc.stats()
        # each dispatch's host seconds (the dispatcher's call of the editor) and its
        # CUDA events (prompt encoding, prepare and the stages), read after the burst;
        # and where in the call the dispatcher's host time goes (dispatch_split_s)
        dispatches = []

        def timed_dispatch(*args, **kw):
            t0 = time.perf_counter()
            pending = type(editor)._dispatch(editor, *args, **kw)
            dispatches.append((time.perf_counter() - t0, list(editor._last_times.events)))
            return pending

        editor._dispatch = timed_dispatch
        t, since = time.perf_counter(), time.perf_counter_ns()
        try:
            replies = concurrently([lambda b=b: http_call(port, "POST", "/v1/edit", b)
                                    for b in bodies])
        finally:
            del editor._dispatch
        wall = time.perf_counter() - t
        posted_images(replies)
        events = [ev for _, evs in dispatches for ev in evs]
        events[-1][2].synchronize()
        device_s = sum(start.elapsed_time(end) for _, start, end in events) / 1e3
        span_s = events[0][1].elapsed_time(events[-1][2]) / 1e3
        lat = [r[2] for r in replies]
        res["burst"] = dict(requests=16, wall_s=wall, requests_per_min=16 * 60 / wall,
                            client_latency_s_mean=statistics.mean(lat),
                            client_latency_s_max=max(lat),
                            server_latency_ms_mean=statistics.mean(r[1]["latency_ms"]
                                                                   for r in replies),
                            hist=hist_delta(before, svc.stats()),
                            dispatch_host_s=sum(h for h, _ in dispatches),
                            dispatches=len(dispatches), device_s=device_s,
                            device_span_s=span_s, device_idle_in_span_s=span_s - device_s,
                            host_only_s=wall - device_s, dispatch_split_s=dispatch_split(since))
        log("[9] the burst's time: wall {wall_s:.3f} s, device work {device_s:.3f} s (first "
            "to last event {device_span_s:.3f} s, idle in it {device_idle_in_span_s:.3f} s), "
            "the dispatcher's host calls {dispatch_host_s:.3f} s over {dispatches} batches, "
            "host only {host_only_s:.3f} s; the calls' host seconds by part "
            "{dispatch_split_s}".format(**res["burst"]))
        log(f"[9] a burst of 16 new prompts: {res['burst']['requests_per_min']:.1f} requests "
            f"per minute, latency mean {res['burst']['client_latency_s_mean']:.3f} s, max "
            f"{res['burst']['client_latency_s_max']:.3f} s, batches {res['burst']['hist']}; "
            f"{card}")

        # the error paths: 400, 404, 503 (a service with no queue), 504
        res["errors"] = {
            "bad_body": http_call(port, "POST", "/v1/edit", {"prompt": "no image"})[0],
            "unknown_route": http_call(port, "GET", "/nope")[0]}
        full = EditService(editor, max_batch=1, max_queue=0)
        try:
            res["errors"]["full_queue"] = http_call(serve_on(full), "POST", "/v1/edit",
                                                    bodies[0])[0]
        finally:
            full.close()
        # two batches of four, then a request with other params behind them that
        # times out while still queued
        short_port = serve_on(svc, SHORT_TIMEOUT_S)
        svc.batch_window_s = COALESCE_WINDOW_S
        before, taken = svc.stats(), len(futures)
        held = [threading.Thread(target=http_call, args=(port, "POST", "/v1/edit", request_body(
            test_image(64 + i), f"a request ahead {i}", guidance_scale=g)[0]))
            for g in (1.5, 1.6) for i in range(4)]
        for th in held:
            th.start()
        while len(futures) < taken + 8:
            time.sleep(0.001)
        code, reply, sec = http_call(short_port, "POST", "/v1/edit", request_body(
            test_image(68), "a request that waits too long", guidance_scale=1.7)[0])
        for th in held:
            th.join()
        late = futures[-1][1]
        res["errors"]["timeout"] = code
        res["timeout"] = dict(client_s=sec, cancelled=late.cancelled(),
                              batches=svc.stats()["batches"] - before["batches"])
        svc.batch_window_s = SERVE_WINDOW_MS / 1000
        log("[9] error paths:", res["errors"], res["timeout"])
        if res["errors"] != dict(bad_body=400, unknown_route=404, full_queue=503, timeout=504):
            raise AssertionError(f"error paths answered {res['errors']}")
        if not late.cancelled():
            raise AssertionError("the timed-out request's future was not cancelled")

        # close() with work in flight resolves every future
        inflight = [svc.submit(test_image(70 + i % 4), f"a request at close {i}")
                    for i in range(6)]
        t = time.perf_counter()
        svc.close(timeout=120)
        res["close"] = dict(seconds=time.perf_counter() - t,
                            resolved=sum(f.done() for f in inflight))
        for f in inflight:
            check_image(f.result(timeout=0))
        if res["close"]["resolved"] != 6:
            raise AssertionError(f"close() left futures unresolved: {res['close']}")
        if any(not f.done() for _, f in futures):
            raise AssertionError("a future of the service is unresolved after close()")
        res["stats"] = svc.stats()
        log("[9] close() with 6 requests in flight:", res["close"], "stats:", res["stats"])
    finally:
        for httpd in servers:
            httpd.shutdown()
            httpd.server_close()
        svc.close()

    # batching is invisible: each batched image against a solo edit of it
    rows = []
    for i, (_, img) in enumerate(four):
        solo = np.asarray(editor.edit(img, prompts[i], seed=7))
        lat = editor.last_latents[0].float()
        diff = np.abs(batched[i].astype(np.int32) - solo.astype(np.int32))
        rows.append(dict(latent_rel_l2=float((batched_latents[i].float() - lat).norm()
                                              / lat.norm()),
                         image_mean_abs_lsb=float(diff.mean()), image_max_abs_lsb=int(diff.max()),
                         same_bits=bool(np.array_equal(batched[i], solo))))
    res["batched_vs_solo"] = rows
    log("[9] each of the batch of four against a solo edit of it:", rows)
    for row in rows:
        if (row["latent_rel_l2"] > E2E_LATENT_REL_L2
                or row["image_mean_abs_lsb"] > E2E_IMAGE_MEAN_LSB):
            raise AssertionError(f"a batched result differs from its solo edit: {row}")

    # the kernels ran: the wrappers' launches are the inventory's, twice (an
    # eager warm-up and a capture) for each key the phase captured
    keys = sorted(k[:4] for k in editor._graphs.edit_keys())
    want = [(1, True, 3, False), (2, True, 3, False), (4, True, 3, False), (4, True, 3, True)]
    if keys != want:
        raise AssertionError(f"phase 9 captured the keys {keys}, expected {want}")
    per_batch = {b: inventory.launches_by_kernel(inventory.kernel_calls(inventory.edit_sites(
        C.SSD1B_UNET, C.SDXL_CONTROLNET_SMALL, C.SDXL_VAE, RESOLUTION, batch=b, steps=3)))
        for b in (1, 2, 4)}
    expected = {k: 2 * sum(per_batch[key[0]][k] for key in keys) for k in per_batch[1]}
    res["launches"] = launch_counts()
    check_launches("phase 9: the keys served, each an eager warm-up and a capture",
                   res["launches"], expected)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[9] phase 9 took {res['seconds']:.1f} s; {card}")
    return res


# ----------------------------------------------------------------- phase 10


def conformance_on_card(card: str) -> dict:
    """Phase 10: ``tools/conformance.py`` on the card against the CPU, which
    must pass and run the flash attention and GroupNorm kernels; then its
    SSIM check with TF32 allowed on the card (outside ``true_fp32()``), which
    must fail, or, where TF32 does not move the stress pair past its
    tolerance, with the device's SSIM inputs cast to bf16, which must."""
    import io
    from unittest import mock

    import torch

    from fastedit_tpu_torch.metrics import functional
    from fastedit_tpu_torch.ops import canny
    from fastedit_tpu_torch.tools import conformance
    from fastedit_tpu_torch.tools.inventory import launch_counts, reset_launch_counts

    res: dict = {}
    t = time.perf_counter()
    reset_launch_counts()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = conformance.main([])
    res["rc"], res["lines"] = rc, text.getvalue().splitlines()
    res["launches"] = {k: v for k, v in {**launch_counts(), **canny.launches}.items() if v}
    for line in res["lines"]:
        log(line)
    if rc != 0:
        raise AssertionError(f"the conformance tool failed on the card: rc {rc}")
    if not all(res["launches"].get(k) for k in (
            "flash_attention_d64_f32", "group_norm_f32", "canny_prepare_f32",
            "canny_hysteresis_f32")):
        raise AssertionError(f"the conformance tool missed a kernel: {res['launches']}")

    # the planted fault on the card: the hysteresis without its unions across
    # tile edges must fail the stress chains
    def broken_hysteresis(cls):
        return canny_with_fault("no_border_unions", "hysteresis", cls[None],
                                torch.float32)[0, ..., 0] > 0

    with mock.patch.object(conformance, "hysteresis", broken_hysteresis):
        fault = conformance.canny_checks(torch.device("cuda"), torch.device("cpu"),
                                         conformance.inputs())
    res["hysteresis_fault"] = {r.name: dict(delta=r.delta, ok=r.ok) for r in fault}
    log("[10] planted fault, the hysteresis without its unions across tile edges:",
        res["hysteresis_fault"])
    chains = res["hysteresis_fault"]["hysteresis chains (device vs fill)"]
    if chains["ok"]:
        raise AssertionError("the conformance tool passes a hysteresis without its unions across "
                             "tile edges")

    device, host, inp = torch.device("cuda"), torch.device("cpu"), conformance.inputs()
    backends = torch.backends
    saved = backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32
    try:
        backends.cuda.matmul.allow_tf32 = backends.cudnn.allow_tf32 = True
        with mock.patch.object(conformance, "true_fp32", contextlib.nullcontext):
            tf32 = conformance.metric_checks(device, host, inp)
    finally:
        backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32 = saved
    res["tf32_fault"] = {r.name: dict(delta=r.delta, tol=r.tol, ok=r.ok) for r in tf32}
    log("[10] planted fault, TF32 allowed:", res["tf32_fault"])
    if tf32[0].ok:
        ssim = functional.ssim

        def bf16_inputs(a, b, **kw):
            if a.is_cuda:
                a, b = a.bfloat16().float(), b.bfloat16().float()
            return ssim(a, b, **kw)

        with mock.patch.object(functional, "ssim", bf16_inputs):
            bf16 = conformance.metric_checks(device, host, inp)
        res["bf16_fault"] = {r.name: dict(delta=r.delta, tol=r.tol, ok=r.ok) for r in bf16}
        log("[10] TF32 passed the stress pair; planted fault, the device's SSIM inputs in "
            "bf16:", res["bf16_fault"])
        if bf16[0].ok:
            raise AssertionError("the SSIM check passes the device's inputs cast to bf16")
    res["seconds"] = time.perf_counter() - t
    log(f"[10] phase 10 took {res['seconds']:.1f} s; {card}")
    return res


# --------------------------------------------------------------------- main


KERNELS = {  # name: (source, TPU kernel it replaces: file:line of pallas_call)
    "conv3x3": ("fastedit_tpu_torch/csrc/conv3x3.cu", "fastedit_tpu/ops/conv3x3.py:169"),
    "flash_attention_d64": ("fastedit_tpu_torch/csrc/flash_attention.cu",
                            "fastedit_tpu/ops/flash_attention.py:253"),
    "flash_attention_d512": ("fastedit_tpu_torch/csrc/flash_attention.cu",
                             "fastedit_tpu/ops/flash_attention.py:97"),
    "conv3x3_up2": ("fastedit_tpu_torch/csrc/conv3x3.cu", "fastedit_tpu/ops/conv_fused.py:433"),
    "conv3x3_down2": ("fastedit_tpu_torch/csrc/conv3x3.cu",
                      "fastedit_tpu/ops/conv_fused.py:610"),
    "conv3x3_fused": ("fastedit_tpu_torch/csrc/conv3x3.cu",
                      "fastedit_tpu/ops/conv_fused.py:221"),
    "group_norm": ("fastedit_tpu_torch/csrc/group_norm.cu",
                   "fastedit_tpu/ops/fused_groupnorm.py:105"),
    # the statistics launch alone; in the JAX package an XLA function
    "group_norm_scale_shift": ("fastedit_tpu_torch/csrc/group_norm.cu",
                               "fastedit_tpu/ops/groupnorm.py:53"),
    # Canny prepare; in the JAX package XLA (canny_jax's stencil and its
    # while_loop hysteresis), no pallas_call
    "canny_prepare": ("fastedit_tpu_torch/csrc/canny.cu", "fastedit_tpu/ops/canny.py:140"),
    # LayerNorm; in the JAX package plain jnp that XLA fuses, no pallas_call
    "layer_norm": ("fastedit_tpu_torch/csrc/layer_norm.cu", "fastedit_tpu/models/layers.py:106"),
    # cross-attention to the text tokens; in the JAX package XLA's attention_xla
    # (the flash kernels' gate wants 128 keys), no pallas_call
    "cross_attention": ("fastedit_tpu_torch/csrc/flash_attention.cu",
                        "fastedit_tpu/ops/attention.py:25"),
}
# The fp32 instances (the quality mode's path, phase 8), each replacing the same
# TPU kernel as its bf16 twin: every conv form and both attention kernels run
# 3xTF32 on the tensor cores, GroupNorm is its own template at float.  The
# cross-attention kernel has none: fp32 cross-attention keeps the plain version.
F32_KERNELS = {
    f"{name}_f32": (source.replace("conv3x3.cu", "conv3x3_tf32x3.cu")
                    .replace("flash_attention.cu", "flash_attention_tf32x3.cu"), replaces)
    for name, (source, replaces) in KERNELS.items() if name != "cross_attention"}
# Kernels built on wgmma (SASS HGMMA), by a part of their mangled name: the bf16
# kernels and the six fp32 ones on 3xTF32.  Every other kernel of every library
# (the phase-weight fold, the TF32 splits, GroupNorm) must hold no tensor-core
# instruction at all, HGMMA or HMMA: TF32 alone is not fp32.
WGMMA_KERNELS = ("conv3x3_kernel", "conv3x3_fused_kernel", "conv3x3_down2_kernel",
                 "conv3x3_up2_kernel", "flash_d64_kernel", "flash_d512_kernel",
                 "conv3x3_tf32x3_kernel", "conv3x3_fused_tf32x3_kernel",
                 "conv3x3_up2_tf32x3_kernel", "conv3x3_down2_tf32x3_kernel",
                 "flash_d64_tf32x3_kernel", "flash_d512_tf32x3_kernel")
# fp32 kernels that must be built and hold no tensor-core instruction, by a part
# of their mangled names: GroupNorm's kernel at float, with its apply and
# without (gn_kernel<float, true>, gn_kernel<float, false>).
SIMT_F32_KERNELS = ("gn_kernelIfLb1E", "gn_kernelIfLb0E")
# The Canny kernel's instances, which must be built and hold no tensor-core
# instruction: integer stencils and union-find, three entries at each type
CANNY_KERNELS = tuple(f"canny_kernelI{t}Li{mode}E" for t in ("13__nv_bfloat16", "f")
                      for mode in range(3))


def kernel_summary(rows: list, main: dict) -> list:
    """One entry per kernel, the bf16 ones and their fp32 instances.  Times
    and bounds are for one edit's calls of that kernel: the sum over its
    shapes of calls per edit x per-call time, in the default configuration
    (fp32: the fp32 edit's; the bound at ``kernel_peak``'s rate).  ``ms``
    and ``library_ms`` are the device's own times, from CUDA graphs;
    ``eager_ms`` and ``library_eager_ms`` are the same from back-to-back
    eager calls, which read the host where a call is short; ``plain_ms`` is eager (the plain
    versions take milliseconds).  ``launches`` are the wrapper's counts over
    the main path's run, which on graphs are its two keys' first calls (an
    eager warm-up and a capture each); ``replay_launches`` are the device
    kernels of one replayed edit, by the profiler.  ``library_ms`` is null
    where no one PyTorch call computes the same function."""
    out = []
    for name, (source, replaces) in {**KERNELS, **F32_KERNELS}.items():
        mine = [r for r in rows if r["kernel"] == name]
        if not mine:
            raise AssertionError(f"no main-path shape reached {name}")

        def per_edit(key, mine=mine):
            return sum(r["calls_edit"] * r[key] for r in mine)

        ops_ms = 1e3 * per_edit("flops") / kernel_peak(name)
        bytes_ms = 1e3 * per_edit("bytes") / PEAK_HBM_BYTES_PER_S
        launches = main["launches"][name]
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches, replay_launches=main["replay_launches"]["edit"][name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=per_edit("ms"), plain_ms=per_edit("plain_ms"), bound_ms=per_edit("bound_ms"),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            library_ms=None if mine[0]["library_ms"] is None else per_edit("library_ms"),
            eager_ms=per_edit("eager_ms"),
            library_eager_ms=(None if mine[0]["library_eager_ms"] is None
                              else per_edit("library_eager_ms")),
        ))
    return out


COMPARES = ("conv", "fused", "up2", "down2", "group_norm", "attention", "canny", "layer_norm",
            "cross_attention")


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the port on one card (no arguments: "
                                 "every phase).")
    ap.add_argument("--only", nargs="+", choices=(*COMPARES, "tensor_parallel"), default=None,
                    help="build, then only these phase-2 rows (bf16 and fp32), or phase 11 "
                         "(tensor_parallel: both arms on a seeded editor); no result line")
    args = ap.parse_args(argv)
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
    from fastedit_tpu_torch.tools.timing import card_line

    card = card_line()
    log(card)
    log("torch", torch.__version__, "cuda", torch.version.cuda, torch.cuda.get_device_name(0))
    t = time.perf_counter()
    nvcc_logs = build.build_all()
    build_s = time.perf_counter() - t
    start_fault_builds()  # needed at phase 2's GroupNorm and Canny rows: builds meanwhile
    log(f"[1] kernels built in {build_s:.2f} s")
    for name, text in nvcc_logs.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line or "Compiling entry" in line
                    or "Performance Loss" in line):
                log(f"  {name}: {line.strip()}")
            # a kernel that spills, or whose wgmmas ptxas serialises (C7513,
            # C7520), still computes the right values: only this stops it
            if "Performance Loss" in line or (
                    "spill stores" in line and "0 bytes spill stores, 0 bytes spill loads"
                    not in line):
                raise AssertionError(f"{name}: ptxas reports {line.strip()}")

    # The per-kernel rule: the kernels of WGMMA_KERNELS hold HGMMA and no HMMA,
    # every other kernel neither (by name, in every library).
    hgmma, simt_seen = {}, set()
    for lib in build.KERNELS:
        counts = count_hgmma(build.library_path(lib))
        hmma = count_hgmma(build.library_path(lib), ("HMMA",))
        if not counts:
            raise AssertionError(f"{lib}: no cuobjdump; the tensor-core rule cannot be checked")
        for name, n in counts.items():
            on_wgmma = any(k in name for k in WGMMA_KERNELS)
            hgmma[name] = dict(HGMMA=n, HMMA=hmma.get(name, 0))
            simt_seen |= {k for k in (*SIMT_F32_KERNELS, *CANNY_KERNELS) if k in name}
            log(f"  {lib}: {n} HGMMA, {hmma.get(name, 0)} HMMA in {name}")
            if on_wgmma != (n > 0) or hmma.get(name, 0):
                raise AssertionError(f"{name}: {n} HGMMA and {hmma.get(name, 0)} HMMA "
                                     f"instructions; {WGMMA_KERNELS}, and only they, are built "
                                     "on the tensor cores (wgmma)")
    missing = {*SIMT_F32_KERNELS, *CANNY_KERNELS} - simt_seen
    if missing:
        raise AssertionError(f"kernels outside the tensor cores not found in the libraries: "
                             f"{missing}")

    log("[2] kernels vs plain versions at the main path's shapes")
    t = time.perf_counter()
    calls = kernel_shapes()
    account_prompt_launches()
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.only:  # a part of phase 2 alone, for work on one kernel
        rows, phase11 = [], None
        for dtype in (torch.bfloat16, torch.float32):
            for name in [n for n in args.only if n != "tensor_parallel"]:
                rows += globals()[f"compare_{name}"](calls, gen, dtype)
                torch.cuda.empty_cache()
        if "tensor_parallel" in args.only:
            from fastedit_tpu_torch import FastEditor

            editor = FastEditor("ssd-1b", random_weights=True)
            seeded_weights_(editor, seed=WEIGHT_SEED)
            kept: dict = {}
            phase11 = tensor_parallel(editor, card, kept=kept)
            phase11["across_processes"] = tensor_parallel_across_processes(card, phase11, kept)
        out = OUT_FILE.with_name("chip_smoke_only.json")
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(card=card, torch=torch.__version__, shapes=rows,
                                       tensor_parallel=phase11, build_s=build_s,
                                       seconds=time.perf_counter() - t),
                                  indent=1, default=str))
        log(f"{len(rows)} rows in {time.perf_counter() - t:.1f} s; {out.relative_to(ROOT)}; "
            f"{card}")
        return 0
    rows = []
    for compare in (compare_conv, compare_fused, compare_up2, compare_down2,
                    compare_group_norm, compare_attention, compare_canny, compare_layer_norm,
                    compare_cross_attention):
        rows += compare(calls, gen)
        torch.cuda.empty_cache()
    host = host_us_per_launch(calls, gen)
    phase2_s = time.perf_counter() - t
    log(f"[2] fp32: each kernel's fp32 instance at the fp32 path's shapes (TF32 off); "
        f"the bf16 rows took {phase2_s:.1f} s")
    t = time.perf_counter()
    for compare in (compare_conv, compare_fused, compare_up2, compare_down2,
                    compare_group_norm, compare_attention, compare_canny, compare_layer_norm,
                    compare_cross_attention):
        rows += compare(calls, gen, torch.float32)
        torch.cuda.empty_cache()
    phase2_f32_s = time.perf_counter() - t

    log("[3] main path: FastEditor('ssd-1b', random_weights=True) at 1024², on CUDA graphs")
    with plain_layer_norms_on_card("phase 3, the bf16 main path"), \
            plain_attention_on_card("phase 3, the bf16 main path"):
        editor, main = main_path(calls)

    log("[4] kernels vs plain versions end to end, seeded weights")
    e2e = kernels_vs_plain(editor, calls)

    log("[5] graphs vs the eager arm; the prompt graph; the graph cache's memory budget")
    vs_eager = graphs_vs_eager(editor)
    vs_eager["prompt_graph"] = prompt_graph_vs_eager(editor)
    vs_eager["memory_sweep"] = graph_memory_sweep(editor)

    log("[9] serving at full width on phase 5's editor: EditService, HTTP, 1024² requests")
    phase9 = serving(editor, card)

    log("[11] tensor parallelism on one card: a group of two shards of cuda:0, then the same "
        "group over two processes")
    kept: dict = {}
    phase11 = tensor_parallel(editor, card, kept=kept)
    phase11["across_processes"] = tensor_parallel_across_processes(card, phase11, kept)

    log("[6] a converted checkpoint: snapshot, converter, FastEditor(checkpoint_dir=...), LoRA, "
        "metrics")
    work = ROOT / "build" / "chip_smoke_checkpoint"
    shutil.rmtree(work, ignore_errors=True)
    try:
        t = time.perf_counter()
        phase6 = checkpoint_and_metrics(editor, calls, card, work)
        phase6["seconds"] = time.perf_counter() - t
        log(f"phase 6 took {phase6['seconds']:.1f} s; {card}")
        del editor
        torch.cuda.empty_cache()

        log("[7] the CLIs at full width on phase 6's checkpoint")
        phase7 = clis_at_full_width(work / "converted", card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    log("[8] the fp32 path: FastEditor('ssd-1b', random_weights=True, use_full_precision=True) "
        "at 1024², on CUDA graphs; then quality mode")
    with plain_layer_norms_on_card("phase 8, the fp32 path"):
        phase8 = f32_path(calls, card)

    log("[10] the conformance tool on the card, then its planted fault")
    phase10 = conformance_on_card(card)

    # the fp32 kernels' launches and replayed device kernels are phase 8's main path's
    kernels = kernel_summary(rows, dict(
        launches={**main["launches"], **{k: v for k, v in phase8["launches"].items()
                                         if is_f32(k)}},
        replay_launches={"edit": {**main["replay_launches"]["edit"],
                                  **{k: v for k, v in phase8["replay_launches"].items()
                                     if is_f32(k)}}}))
    OUT_FILE.parent.mkdir(parents=True, exist_ok=True)
    OUT_FILE.write_text(json.dumps(dict(
        card=card, torch=torch.__version__, cuda=torch.version.cuda, kernels=kernels,
        shapes=rows, host=host, main_path=main, kernels_vs_plain=e2e,
        graphs_vs_eager=vs_eager, checkpoint_and_metrics=phase6, clis=phase7,
        f32_path=phase8, serving=phase9, conformance=phase10, tensor_parallel=phase11,
        phase2_s=phase2_s, phase2_f32_s=phase2_f32_s, build_s=build_s, hgmma=hgmma,
        seconds_total=time.perf_counter() - t_start,
    ), indent=1, default=str))
    log(f"total {time.perf_counter() - t_start:.1f} s; details in {OUT_FILE.relative_to(ROOT)}")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
