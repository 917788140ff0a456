"""The pixel path as CUDA graphs: the counterpart of the JAX package's
``make_edit_core`` and its per-stage programs (``fastedit_tpu/pipeline/
stages.py``).

The JAX package runs Canny prepare, VAE encode, the denoise loop and VAE
decode as jitted programs, one dispatch each, or one for the whole edit.
Eager PyTorch enqueues every launch of an edit from the host instead (some
8,600 for SSD-1B at 1024²).  Here each of the four stages is captured once
per key as a ``torch.cuda.CUDAGraph`` and replayed, one launch per stage,
back to back:

* the key (:func:`graph_key`) is everything the captured launches depend on:
  batch, CFG, the number of run steps, noise tiling and resolution.  The
  kernel plan is a constant of each stage (``ops/flags.py``), and graphs run
  only with both kernel flags at their defaults, so neither is in the key;
* a capture's static buffers (:class:`EditInputs`) hold what its graphs
  read: the uint8 images, both Canny thresholds, the noise draws, the prompt
  embeddings, time ids, the schedule table and both scales.  A replay first
  copies the call's tensors into them: the kernel wrappers encode TMA
  tensor maps from data pointers, so a graph is right only on the buffers it
  was captured on.  The thresholds, the schedule and the scales are
  tensors, so one capture serves every threshold, strength and scale with
  the same number of run steps;
* prepare's outputs (the control image and the VAE input) are the capture's
  own tensors, held by it (:attr:`Captured.prepared`): the denoise graph
  reads the control image that the prepare graph writes.  The union-find
  labels of the hysteresis are allocated and freed inside prepare's capture,
  so they stay in the pool for as long as the graphs live, and a later
  capture may reuse them only for its own intermediates, as with every
  stage's: the chain replays in capture order;
* a capture follows one eager run of the same key on the same buffers (the
  kernels built, the GroupNorm kernel's counter buffer sized, the conv
  modules' fp32 biases and folded weights made, cuBLAS warm), on a side
  stream; all captures of an editor allocate from one memory pool, since
  they replay one at a time from one thread, and on one side stream, the
  editor's own: the caching allocator hands a freed block out again only on
  the stream it was freed on, so with a new stream per capture every key
  would take a pool of its own size (GiBs for SSD-1B at 1024²), and with one
  a key of a size captured before costs its static buffers.  The price of one
  pool: keys replay in any order, so a replay may write over another key's
  outputs (PyTorch shares a pool safely only in capture order); whatever
  reads a capture's outputs does so before the next replay of any key (the
  editor copies its images and prompt rows out at once);
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

Prompt encoding is a graph of its own per padded number of prompts
(:func:`prompt_key`, :meth:`EditGraphs.encode_prompts`), the counterpart of
the JAX package's jitted ``make_encode_prompt``: two int64 token-id buffers
[padded, 77] in, the context [padded, 77, D] and pooled [padded, P]
embeddings out, in the same cache, pool, capture stream, count cap and
memory budget as the edit's keys.  Its outputs are overwritten by the next
replay: the editor caches copies of their rows.  A capture or replay that
fails raises; nothing runs the eager path in its place.  :func:`run_eager`
is the same four stages without graphs: on the CPU, and under
``flags.override(cuda_graphs=False)`` or ``plain_versions=True``.

Spans (``utils/profiling.py``), each with the edit's id: ``graphs.lookup``
(the weights' check and the key's look-up), ``graphs.capture`` per new key
(room made, ``graphs.warmup`` for the eager run, the capture), then
``graphs.copy_inputs`` and one ``graphs.replay`` per stage (``stage`` in its
ids); counters ``graphs.captures`` and ``graphs.evictions`` (keys dropped
past the cap, for memory, or because a weight changed); at each capture a
``graphs.kernels`` record per graph: its kernel nodes (``kernels``), with
``stage`` and the key's ``batch``, ``cfg`` and ``steps`` (a prompt graph's
``padded``), counted in the graph as its capture ends (:func:`capturing_graph`,
:func:`kernel_nodes`).

The denoise stage stamps the card's clock at each step's ControlNet start,
UNet start and UNet end (``stages.denoise``'s ``marks``) into a buffer the
capture owns (:attr:`Captured.marks`; an eager run on the card makes its
own).  A replay overwrites it, so after each run the buffer is handed to
the edit's ``timed`` (its ``keep_marks``), which copies it out on the same
stream, behind the run and before any later replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import time
from collections import OrderedDict
from typing import Optional

import torch

from fastedit_tpu_torch.pipeline import stages
from fastedit_tpu_torch.sched.lcm import LCMSchedule
from fastedit_tpu_torch.utils import profiling

MAX_KEYS = 64
# The share of the card's memory (``torch.cuda.mem_get_info``'s total) that
# what is in use, plus the next capture, may take; keys are evicted, oldest
# first, to keep under it.
MEMORY_BUDGET = 0.9
STAGES = ("prepare", "vae_encode", "denoise", "vae_decode")


def graph_key(batch: int, do_cfg: bool, steps: int, tile_noise: bool,
              resolution: int) -> tuple:
    """What one capture serves: its shapes."""
    return (batch, do_cfg, steps, tile_noise, resolution)


def prompt_key(padded: int) -> tuple:
    """What one prompt capture serves: the padded number of prompts."""
    return ("prompt", padded)


@dataclasses.dataclass
class EditInputs:
    """Every tensor the four stages read, for one call."""

    images: torch.Tensor  # uint8 [B, r, r, 3]
    canny_low: torch.Tensor  # 0-dim int32, floored, <= canny_high (canny.threshold_tensors)
    canny_high: torch.Tensor  # 0-dim int32
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
    control_res: int  # the ControlNet conditioning image's size (the key's resolution fixes it)

    TENSORS = ("images", "canny_low", "canny_high", "eps_enc", "noise_init", "context", "pooled",
               "time_ids", "guidance", "controlnet_scale")

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


def _stage_fns(mod: stages.PipelineModules, inp: EditInputs, prepared: dict,
               marks: Optional[torch.Tensor] = None):
    """(name, fn) per stage, in order; each fn takes the previous stage's
    output (prepare's: the VAE input; then the latents) and returns its own.
    Prepare also leaves its outputs in ``prepared``, where denoise reads the
    control image; denoise stamps ``marks`` where given."""
    def prepare(_):
        prepared["control"], prepared["vae_in"] = stages.prepare(
            mod, inp.images, inp.canny_low, inp.canny_high, inp.control_res)
        return prepared["vae_in"]

    return (
        ("prepare", prepare),
        ("vae_encode", lambda vae_in: stages.vae_sample(mod, vae_in, inp.eps_enc)),
        ("denoise", lambda latents: stages.denoise(
            mod, latents, inp.context, inp.pooled, inp.time_ids, prepared["control"],
            inp.schedule, inp.guidance, inp.controlnet_scale, inp.noise_init, inp.step_noise,
            inp.do_cfg, marks)),
        ("vae_decode", lambda latents: stages.vae_decode(mod, latents)),
    )


def _marks(inp: EditInputs) -> Optional[torch.Tensor]:
    """A buffer for the denoise stage's stamps on the card; none off it."""
    if not inp.images.is_cuda:
        return None
    return torch.empty(stages.STAMPS_PER_STEP * inp.schedule.num_steps, dtype=torch.int64,
                       device=inp.images.device)


def _keep_marks(timed, marks: Optional[torch.Tensor]) -> None:
    """Hand a run's stamps to ``timed`` where it keeps them (the editor's
    ``StageTimes``), to be copied out behind the run."""
    keep = getattr(timed, "keep_marks", None)
    if keep is not None and marks is not None:
        keep(marks)


def run_eager(mod: stages.PipelineModules, inp: EditInputs,
              timed=contextlib.nullcontext) -> tuple[torch.Tensor, torch.Tensor]:
    """The four stages op by op; returns (final latents, uint8 images).
    ``timed(name)`` is entered around each stage."""
    x = latents = None
    marks = _marks(inp)
    for name, fn in _stage_fns(mod, inp, {}, marks):
        with timed(name):
            x = fn(x)
        if name == "denoise":
            latents = x
    _keep_marks(timed, marks)
    return latents, x


@dataclasses.dataclass
class Captured:
    """One key's graphs, the buffers they read and the outputs they write."""

    inputs: EditInputs
    graphs: dict  # stage name -> torch.cuda.CUDAGraph, in replay order
    latents: torch.Tensor  # the denoise graph's output
    out: torch.Tensor  # the decode graph's output, uint8 [B, r, r, 3]
    pool_bytes: int  # memory the pool reserved for this capture
    # the prepare graph's outputs, "control" and "vae_in" (denoise reads the control)
    prepared: dict = dataclasses.field(default_factory=dict)
    # the denoise graph's stamps (stages.denoise_split), overwritten by each replay
    marks: Optional[torch.Tensor] = None


@dataclasses.dataclass
class PromptCaptured:
    """One padded prompt count's graph, the token ids it reads and the
    embeddings it writes."""

    ids: tuple  # two int64 [padded, 77] buffers, one per text encoder
    graphs: dict  # {"encode_prompt": torch.cuda.CUDAGraph}
    context: torch.Tensor  # [padded, 77, D]
    pooled: torch.Tensor  # [padded, P]
    pool_bytes: int


class EditGraphs:
    """One editor's captures, by :func:`graph_key`, on one memory pool."""

    def __init__(self, mod: stages.PipelineModules):
        self.mod = mod
        self.captured: OrderedDict[tuple, Captured | PromptCaptured] = OrderedDict()
        self.pool = None
        self._side = None  # the stream every capture runs on (see the module's docstring)
        models = [getattr(mod, name, None) for name in
                  ("unet", "controlnet", "vae", "text_encoder", "text_encoder_2")]
        self._params = [p for m in models if m is not None for p in m.parameters()]
        self._weights: Optional[tuple] = None

    def clear(self) -> None:
        """Drop every capture and the pool."""
        self.captured.clear()
        self.pool = None

    def _weights_version(self) -> tuple:
        return (sum(p._version for p in self._params),
                hash(tuple(p.data_ptr() for p in self._params)))

    def edit_keys(self) -> list:
        """The keys of the edit's captures (not the prompt graphs')."""
        return [k for k, c in self.captured.items() if isinstance(c, Captured)]

    def _lookup(self, key: tuple, capture, edit: Optional[int] = None):
        """``key``'s capture, made by ``capture()`` if new (after room is
        made for it); every capture is dropped first if a weight changed."""
        with profiling.span("graphs.lookup", edit=edit):
            version = self._weights_version()
            if version != self._weights:
                if self.captured:
                    profiling.count("graphs.evictions", len(self.captured))
                self.clear()
                self._weights = version
            cap = self.captured.get(key)
        if cap is None:
            with profiling.span("graphs.capture", prompt=int(key[0] == "prompt"), edit=edit):
                self._make_room()
                cap = self.captured[key] = capture()
                profiling.count("graphs.captures")
                while len(self.captured) > MAX_KEYS:
                    self.captured.popitem(last=False)
                    profiling.count("graphs.evictions")
        return cap

    @staticmethod
    def _replay(cap, timed, edit: Optional[int]) -> None:
        for name, graph in cap.graphs.items():
            with profiling.span("graphs.replay", stage=name, edit=edit), timed(name):
                graph.replay()

    def run(self, key: tuple, inp: EditInputs, timed=contextlib.nullcontext,
            edit: Optional[int] = None):
        """Replay ``key``'s graphs on ``inp`` (captured first if new);
        returns (final latents, uint8 images), the capture's own output
        buffers, valid until the next replay of any key: captures share one
        pool, so an earlier capture's replay may write where a later one's
        outputs lie.  ``timed(name)`` is entered around each replay."""
        cap = self._lookup(key, lambda: self._capture(inp), edit)
        with profiling.span("graphs.copy_inputs", edit=edit):
            cap.inputs.copy_(inp)
        self._replay(cap, timed, edit)
        _keep_marks(timed, cap.marks)
        return cap.latents, cap.out

    def encode_prompts(self, key: tuple, ids_1: torch.Tensor, ids_2: torch.Tensor,
                       timed=contextlib.nullcontext, edit: Optional[int] = None):
        """Replay ``key``'s prompt graph (:func:`prompt_key`; captured first
        if new) on host token ids, int64 [padded, 77] each, copied in from
        pinned memory without a sync; returns (context, pooled), the
        capture's own output buffers, valid until the next replay of any key
        (see :meth:`run`)."""
        cap = self._lookup(key, lambda: self._capture_prompts(ids_1, ids_2), edit)
        with profiling.span("graphs.copy_inputs", edit=edit):
            for dst, src in zip(cap.ids, (ids_1, ids_2), strict=True):
                if dst.shape != src.shape:
                    raise ValueError(f"token ids of shape {tuple(src.shape)} for a buffer of "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src.pin_memory(), non_blocking=True)
        self._replay(cap, timed, edit)
        return cap.context, cap.pooled

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
            profiling.count("graphs.evictions")
            if not self.captured:
                self.pool = None  # no graph uses the pool: empty_cache may release it

    def _capture(self, inp: EditInputs) -> Captured:
        static, prepared, marks = inp.clone(), {}, _marks(inp)
        graphs, outs, pool_bytes = self._capture_chain(
            static.images.device, _stage_fns(self.mod, static, prepared, marks),
            dict(batch=inp.images.shape[0], cfg=inp.do_cfg, steps=inp.schedule.num_steps))
        return Captured(static, graphs, outs["denoise"], outs["vae_decode"], pool_bytes,
                        prepared, marks)

    def _capture_prompts(self, ids_1: torch.Tensor, ids_2: torch.Tensor) -> PromptCaptured:
        device = self._params[0].device
        ids = (ids_1.to(device), ids_2.to(device))
        graphs, outs, pool_bytes = self._capture_chain(
            device, (("encode_prompt", lambda _: stages.encode_prompt(self.mod, *ids)),),
            dict(padded=ids_1.shape[0]))
        return PromptCaptured(ids, graphs, *outs["encode_prompt"], pool_bytes)

    def _capture_chain(self, device: torch.device, fns, key_ids: dict
                       ) -> tuple[dict, dict, int]:
        """Run ``fns`` ((name, fn) pairs, each fn taking the previous one's
        output) once eagerly on the capture stream, the warm-up, then capture
        each as a graph on the shared pool, recording its kernel nodes with
        ``key_ids``; returns (graphs by name, outputs by name, the bytes the
        pool grew by)."""
        if self._side is None:
            self._side = torch.cuda.Stream(device=device)
        side = self._side
        with profiling.span("graphs.warmup"):
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                x = None
                for _, fn in fns:
                    x = fn(x)
            side.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graphs, outs, x = {}, {}, None
        for name, fn in fns:
            graph = torch.cuda.CUDAGraph()
            # thread_local: a loader thread may stage the next batch meanwhile
            with torch.cuda.graph(graph, pool=self.pool, stream=side,
                                  capture_error_mode="thread_local"):
                x = fn(x)
                # counted in the graph being built: with the graph kept past its
                # capture (CUDAGraph(keep_graph=True)) instead, served requests'
                # median latency read 5-10% higher on an H100
                kernels = kernel_nodes(capturing_graph(side.cuda_stream))
            t = time.perf_counter_ns()
            profiling.record("graphs.kernels", t, t, stage=name, kernels=kernels, **key_ids)
            graphs[name], outs[name] = graph, x
        torch.cuda.current_stream().wait_stream(side)
        return graphs, outs, torch.cuda.memory_reserved() - reserved


# CUgraphNodeType (cuda.h): a kernel, and a child graph whose nodes count too;
# CU_STREAM_CAPTURE_STATUS_ACTIVE
_KERNEL_NODE, _CHILD_GRAPH_NODE = 0, 4
_CAPTURE_ACTIVE = 1
_libcuda: Optional[ctypes.CDLL] = None


def _load_libcuda() -> ctypes.CDLL:
    global _libcuda
    if _libcuda is None:
        lib = ctypes.CDLL("libcuda.so.1")
        p, size = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
        for fn, args in (("cuStreamGetCaptureInfo_v2", [p, ctypes.POINTER(ctypes.c_int), p,
                                                        ctypes.POINTER(p), p, p]),
                         ("cuGraphGetNodes", [p, ctypes.POINTER(p), size]),
                         ("cuGraphNodeGetType", [p, ctypes.POINTER(ctypes.c_int)]),
                         ("cuGraphChildGraphNodeGetGraph", [p, ctypes.POINTER(p)])):
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = args, ctypes.c_int
        _libcuda = lib
    return _libcuda


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUresult {err}")


def capturing_graph(stream: int, lib=None) -> int:
    """The ``cudaGraph_t`` (a handle as an int) that a capture in progress
    on ``stream`` (a ``cudaStream_t`` as an int) is building, through
    libcuda's ``cuStreamGetCaptureInfo``; raises where none is."""
    cu = _load_libcuda() if lib is None else lib
    status, graph = ctypes.c_int(0), ctypes.c_void_p()
    _check(cu.cuStreamGetCaptureInfo_v2(stream, ctypes.byref(status), None, ctypes.byref(graph),
                                        None, None), "cuStreamGetCaptureInfo")
    if status.value != _CAPTURE_ACTIVE or not graph.value:
        raise RuntimeError(f"no capture in progress on stream {stream:#x} (status {status.value})")
    return graph.value


def kernel_nodes(graph: int, lib=None) -> int:
    """The kernel nodes of a ``cudaGraph_t`` (a handle as an int), child
    graphs' included, through libcuda's ``cuGraphGetNodes`` and
    ``cuGraphNodeGetType`` (``lib``, or a stand-in with those calls): the
    launches one replay makes."""
    cu = _load_libcuda() if lib is None else lib
    n = ctypes.c_size_t(0)
    _check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    count = 0
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        _check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value == _KERNEL_NODE:
            count += 1
        elif kind.value == _CHILD_GRAPH_NODE:
            child = ctypes.c_void_p()
            _check(cu.cuGraphChildGraphNodeGetGraph(node, ctypes.byref(child)),
                  "cuGraphChildGraphNodeGetGraph")
            count += kernel_nodes(child.value, cu)
    return count


def _card_memory(device: torch.device) -> tuple[int, int]:
    """(bytes in use, total bytes) of ``device`` after ``empty_cache``: the
    card's used memory (every process's) less the blocks this process has
    reserved but not allocated, which stay in a live graph pool for the next
    capture to reuse."""
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(device)
    reusable = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return total - free - reusable, total
