"""The pixel path as CUDA graphs: the counterpart of the JAX package's
``make_edit_core`` and its per-stage programs (``fastedit_tpu/pipeline/
stages.py``).

The JAX package runs VAE encode, the denoise loop and VAE decode as jitted
programs, one dispatch each, or one for the whole edit.  Eager PyTorch
enqueues every launch of an edit from the host instead (some 8,600 for
SSD-1B at 1024²).  Here each of the three stages is captured once per key as
a ``torch.cuda.CUDAGraph`` and replayed, one launch per stage, back to back:

* the key (:func:`graph_key`) is everything the captured launches depend on:
  batch, CFG, the number of run steps, noise tiling, resolution, and every
  kernel flag, since the flags are read in Python while a stage runs and a
  capture bakes in what they said;
* a capture's static buffers (:class:`EditInputs`) hold what its graphs
  read: the VAE input, the Canny control, the noise draws, the prompt
  embeddings, time ids, the schedule table and both scales.  A replay first
  copies the call's tensors into them: the kernel wrappers encode TMA
  tensor maps from data pointers, so a graph is right only on the buffers it
  was captured on.  The schedule and the scales are tensors, so one capture
  serves every strength and scale with the same number of run steps;
* a capture follows one eager run of the same key on the same buffers (the
  kernels built, the GroupNorm kernel's counter buffer sized, the conv
  modules' fp32 biases and folded weights made, cuBLAS warm), on a side
  stream; all captures of an editor allocate from one memory pool, since
  they replay one at a time from one thread, and on one side stream, the
  editor's own: the caching allocator hands a freed block out again only on
  the stream it was freed on, so with a new stream per capture every key
  would take a pool of its own size (GiBs for SSD-1B at 1024²), and with one
  a key of a size captured before costs its static buffers;
* at most :data:`MAX_KEYS` keys are kept, the oldest evicted, as the JAX
  package caps its caches.  A capture also holds memory, which a JAX program
  does not (its static buffers, and the pool's growth where it is the
  largest so far), so before a new capture the oldest keys are evicted until
  the card's memory in use plus the largest capture so far fits
  :data:`MEMORY_BUDGET` of the card
  (:meth:`EditGraphs._make_room`); where evicting every key is not enough,
  the capture is refused with an error instead of running out of memory;
* a change to the weights (another tensor, or one written in place) drops
  every capture, since what the conv modules derive from the weights is made
  again.

Prepare (Canny) stays outside, eager: its hysteresis loop reads a device
flag on the host.  Prompt encoding stays eager and cached, as in the JAX
package.  A capture or replay that fails raises; nothing runs the eager
path in its place.  :func:`run_eager` is the same three stages without
graphs: on the CPU, and under ``flags.override(cuda_graphs=False)`` or
``plain_versions=True``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import OrderedDict
from typing import Optional

import torch

from fastedit_tpu_torch.ops import flags
from fastedit_tpu_torch.pipeline import stages
from fastedit_tpu_torch.sched.lcm import LCMSchedule

MAX_KEYS = 64
# The share of the card's memory (``torch.cuda.mem_get_info``'s total) that
# what is in use, plus the next capture, may take; keys are evicted, oldest
# first, to keep under it.
MEMORY_BUDGET = 0.9
STAGES = ("vae_encode", "denoise", "vae_decode")


def graph_key(batch: int, do_cfg: bool, steps: int, tile_noise: bool,
              resolution: int) -> tuple:
    """What one capture serves: its shapes and every kernel flag in force
    in the calling thread."""
    return (batch, do_cfg, steps, tile_noise, resolution, dataclasses.astuple(flags.current()))


@dataclasses.dataclass
class EditInputs:
    """Every tensor the three stages read, for one call."""

    vae_in: torch.Tensor  # [B, r, r, 3] model dtype, in [-1, 1]
    control: torch.Tensor  # [B, c, c, 3] model dtype, in [0, 1]
    eps_enc: torch.Tensor  # fp32 [Bn, r/8, r/8, 4]; Bn = 1 with tiled noise, else B
    noise_init: torch.Tensor  # fp32, eps_enc's shape
    step_noise: tuple  # one fp32 draw per run step, eps_enc's shape
    context: torch.Tensor  # [B or 2B, 77, D]
    pooled: torch.Tensor  # [B or 2B, P]
    time_ids: torch.Tensor  # [B or 2B, 6]
    schedule: LCMSchedule  # its table on the device; the denoise loop reads
    # nothing else of it but num_steps and is_last, which the key fixes
    guidance: torch.Tensor  # 0-dim, model dtype (stages.edit_scalars)
    controlnet_scale: torch.Tensor  # 0-dim fp32
    do_cfg: bool

    TENSORS = ("vae_in", "control", "eps_enc", "noise_init", "context", "pooled", "time_ids",
               "guidance", "controlnet_scale")

    def tensors(self) -> list:
        return [*(getattr(self, f) for f in self.TENSORS), *self.step_noise,
                self.schedule.table]

    def clone(self) -> "EditInputs":
        """Buffers of the same shapes holding the same values."""
        return dataclasses.replace(
            self, **{f: getattr(self, f).clone() for f in self.TENSORS},
            step_noise=tuple(t.clone() for t in self.step_noise),
            schedule=dataclasses.replace(self.schedule, table=self.schedule.table.clone()))

    def copy_(self, other: "EditInputs") -> None:
        """Copy ``other``'s tensors into these (the same shapes: ``copy_``
        alone would broadcast a batch of 1 over a larger buffer)."""
        for dst, src in zip(self.tensors(), other.tensors(), strict=True):
            if dst.shape != src.shape:
                raise ValueError(f"graph input of shape {tuple(src.shape)} for a buffer of "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)


def _stage_fns(mod: stages.PipelineModules, inp: EditInputs):
    """(name, fn) per stage, in order; each fn takes the previous stage's
    output (the latents) and returns its own."""
    return (
        ("vae_encode", lambda _: stages.vae_sample(mod, inp.vae_in, inp.eps_enc)),
        ("denoise", lambda latents: stages.denoise(
            mod, latents, inp.context, inp.pooled, inp.time_ids, inp.control, inp.schedule,
            inp.guidance, inp.controlnet_scale, inp.noise_init, inp.step_noise, inp.do_cfg)),
        ("vae_decode", lambda latents: stages.vae_decode(mod, latents)),
    )


def run_eager(mod: stages.PipelineModules, inp: EditInputs,
              timed=contextlib.nullcontext) -> tuple[torch.Tensor, torch.Tensor]:
    """The three stages op by op; returns (final latents, uint8 images).
    ``timed(name)`` is entered around each stage."""
    x = latents = None
    for name, fn in _stage_fns(mod, inp):
        with timed(name):
            x = fn(x)
        if name == "denoise":
            latents = x
    return latents, x


@dataclasses.dataclass
class Captured:
    """One key's graphs, the buffers they read and the outputs they write."""

    inputs: EditInputs
    graphs: dict  # stage name -> torch.cuda.CUDAGraph, in replay order
    latents: torch.Tensor  # the denoise graph's output
    out: torch.Tensor  # the decode graph's output, uint8 [B, r, r, 3]
    pool_bytes: int  # memory the pool reserved for this capture


class EditGraphs:
    """One editor's captures, by :func:`graph_key`, on one memory pool."""

    def __init__(self, mod: stages.PipelineModules):
        self.mod = mod
        self.captured: OrderedDict[tuple, Captured] = OrderedDict()
        self.pool = None
        self._side = None  # the stream every capture runs on (see the module's docstring)
        self._params = [p for m in (mod.unet, mod.controlnet, mod.vae) for p in m.parameters()]
        self._weights: Optional[tuple] = None

    def clear(self) -> None:
        """Drop every capture and the pool."""
        self.captured.clear()
        self.pool = None

    def _weights_version(self) -> tuple:
        return (sum(p._version for p in self._params),
                hash(tuple(p.data_ptr() for p in self._params)))

    def run(self, key: tuple, inp: EditInputs, timed=contextlib.nullcontext):
        """Replay ``key``'s graphs on ``inp`` (captured first if new);
        returns (final latents, uint8 images), the capture's own output
        buffers, which the next replay of the key overwrites."""
        version = self._weights_version()
        if version != self._weights:
            self.clear()
            self._weights = version
        cap = self.captured.get(key)
        if cap is None:
            self._make_room()
            cap = self.captured[key] = self._capture(inp)
            while len(self.captured) > MAX_KEYS:
                self.captured.popitem(last=False)
        cap.inputs.copy_(inp)
        for name, graph in cap.graphs.items():
            with timed(name):
                graph.replay()
        return cap.latents, cap.out

    def _make_room(self) -> None:
        """Evict the oldest keys until the next capture fits: the card's
        memory in use (after ``empty_cache``: what the process and others hold,
        less the blocks free in the shared pool, which the next capture reuses)
        plus a margin, the largest capture's ``pool_bytes`` so far, within
        :data:`MEMORY_BUDGET` of the card.  Raises where that does not hold
        with no key left."""
        margin = max((c.pool_bytes for c in self.captured.values()), default=0)
        if margin <= 0:
            return  # no capture so far to go by
        while True:
            in_use, total = _card_memory(self._params[0].device)
            if in_use + margin <= MEMORY_BUDGET * total:
                return
            if not self.captured:
                raise RuntimeError(
                    f"CUDA graph cache: the next capture needs about {margin / 2**30:.2f} GiB, "
                    f"but with every key evicted {in_use / 2**30:.2f} of the card's "
                    f"{total / 2**30:.2f} GiB are in use (budget {MEMORY_BUDGET:.0%}); free "
                    "memory or run eagerly (flags.override(cuda_graphs=False))")
            self.captured.popitem(last=False)
            if not self.captured:
                self.pool = None  # no graph uses the pool: empty_cache may release it

    def _capture(self, inp: EditInputs) -> Captured:
        static = inp.clone()
        if self._side is None:
            self._side = torch.cuda.Stream(device=static.vae_in.device)
        side = self._side
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run_eager(self.mod, static)  # the warm-up
        side.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graphs, x, latents = {}, None, None
        for name, fn in _stage_fns(self.mod, static):
            graph = torch.cuda.CUDAGraph()
            # thread_local: a loader thread may stage the next batch meanwhile
            with torch.cuda.graph(graph, pool=self.pool, stream=side,
                                  capture_error_mode="thread_local"):
                x = fn(x)
            graphs[name] = graph
            if name == "denoise":
                latents = x
        torch.cuda.current_stream().wait_stream(side)
        return Captured(static, graphs, latents, x, torch.cuda.memory_reserved() - reserved)


def _card_memory(device: torch.device) -> tuple[int, int]:
    """(bytes in use, total bytes) of ``device`` after ``empty_cache``: the
    card's used memory (every process's) less the blocks this process has
    reserved but not allocated, which stay in a live graph pool for the next
    capture to reuse."""
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(device)
    reusable = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return total - free - reusable, total
