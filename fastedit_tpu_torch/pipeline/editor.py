"""FastEditor — the one-call image editing facade, on one NVIDIA card.

The same constructor knobs, ``MODEL_CONFIGS`` keys and methods as the JAX
package's ``FastEditor``: ``preprocess_image``, ``edit`` (with
``strength``), ``edit_batch`` (on PIL images, a pre-resized uint8 array or
a batch already on the device), ``stage_inputs``, ``edit_batch_async``
(a :class:`PendingEdit`), ``warmup``, ``clear_memory`` and
``get_memory_usage``.  It runs on the card unless the caller asks for
``device="cpu"``; on the card the pixel path and the encoding of new prompts
replay CUDA graphs (``pipeline/graphs.py``), the counterpart of the JAX
package's jitted programs, unless ``flags.override(cuda_graphs=False)`` asks for the
eager arm.  By default the weights load from a converted checkpoint
directory (``checkpoint_dir``, else ``checkpoints/<model_name>``), the layout
``tools/convert_checkpoint.py`` writes and the JAX package reads;
``random_weights=True`` builds the full architecture with zero weights (edit
latency does not depend on the weights), and ``"tiny"`` is a seeded
random-weight smoke model with the real topology.

``enable_data_parallel`` splits later batches over one replica per device
(``parallel/replicas.py``, the counterpart of the JAX package's device
mesh), and over processes once ``parallel/multihost.initialize`` has run.

``use_full_precision=True`` (or ``dtype=torch.float32``) is the reference's
fp32 configuration, and with ``use_full_controlnet=True`` its quality mode:
weights and activations in fp32, every kernel call on the kernel's fp32
instance (the same gates and counts as bf16, ``tools/inventory.py``), and
the whole edit (prompt encoding, prepare, the stages, eager or captured)
inside ``utils/precision.true_fp32``, so PyTorch's own fp32 matmuls and
cuDNN convs run without TF32 as well.

``enable_data_parallel(..., model_parallel=k)`` adds tensor parallelism
(``parallel/tp.py``) within each group of ``k`` devices, which may span
processes.

Spans (``utils/profiling.py``): ``facade.build`` around the constructor
(``facade.init_weights`` for the modules' build and fill), ``facade.stage``
around ``stage_inputs``; each ``edit_batch_async`` (and ``edit``) call takes
an ``edit`` id, which its spans carry: ``facade.encode_prompts`` for new
prompts (``facade.tokenize`` inside), ``facade.inputs``, the graphs layer's
(``pipeline/graphs.py``), ``facade.readback_enqueue`` (the pinned buffer and
the copy), then on the reading thread ``facade.readback`` with
``facade.readback_wait`` and ``facade.to_pil`` inside.  Once read back, the
CUDA events around each stage give one ``stage.<name>`` record per stage:
its device ns in ``device_ns``, with ``edit`` and ``rows``; on the card the
denoise stage's stamps (``pipeline/stages.denoise_split``) give two more,
``stage.denoise.controlnet`` and ``stage.denoise.unet``, with the same ids.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import math
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
from PIL import Image

from fastedit_tpu_torch.models import configs as C
from fastedit_tpu_torch.models.clip import CLIPTextModel
from fastedit_tpu_torch.models.controlnet import ControlNetModel
from fastedit_tpu_torch.models.layers import GroupNorm, LayerNorm, cast_model
from fastedit_tpu_torch.models.unet import UNet2DConditionModel
from fastedit_tpu_torch.models.vae import AutoencoderKL
from fastedit_tpu_torch.ops import flags
from fastedit_tpu_torch.ops import canny
from fastedit_tpu_torch.pipeline import graphs, stages
from fastedit_tpu_torch.sched.lcm import LCMSchedulerConfig, make_schedule
from fastedit_tpu_torch.text.tokenizer import CLIPTokenizer
from fastedit_tpu_torch.tools import from_jax
from fastedit_tpu_torch.utils import checkpoint as ckpt_io
from fastedit_tpu_torch.utils import profiling
from fastedit_tpu_torch.utils.image import resize
from fastedit_tpu_torch.utils.logging import get_logger
from fastedit_tpu_torch.utils.precision import true_fp32
from fastedit_tpu_torch.utils.profiling import nan_checks_enabled

log = get_logger("FastEditor")
_EDIT_IDS = itertools.count(1)


def _normalize_dtype(dtype) -> torch.dtype:
    """Accept torch/numpy dtypes and strings; float16 maps to bf16."""
    name = str(dtype).replace("torch.", "")
    mapping = {
        "float16": torch.bfloat16,
        "half": torch.bfloat16,
        "bfloat16": torch.bfloat16,
        "float32": torch.float32,
        "float": torch.float32,
        "float64": torch.float32,
    }
    if name not in mapping:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return mapping[name]


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _resolve_device(device: Optional[str]) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' to run the plain versions on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@torch.no_grad()
def _seeded_init_(model: nn.Module, generator: torch.Generator) -> None:
    """Fan-in-scaled normal weights, zero biases, identity norms."""
    for m in model.modules():
        if isinstance(m, (GroupNorm, LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, fan_in**-0.5, generator=generator)
            if m.bias is not None:
                m.bias.zero_()


def _build(cls, cfg, device, dtype, generator: Optional[torch.Generator] = None,
           state_dict: Optional[dict] = None):
    """Construct without initialising (meta), allocate on ``device`` and
    fill: ``state_dict`` (cast to the parameters' dtypes as it is copied
    in), seeded random weights with a generator, zeros without either."""
    with torch.device("meta"):
        model = cls(cfg)
    cast_model(model, None, dtype)
    model.to_empty(device=device)
    with torch.no_grad():
        if state_dict is not None:
            model.load_state_dict(state_dict)
        elif generator is None:
            for p in model.parameters():
                p.zero_()
        else:
            _seeded_init_(model, generator)
    return model.eval().requires_grad_(False)


class StageTimes:
    """One edit's device time by stage: entered as ``timed(name)`` around
    each stage (prompt encoding, prepare, VAE encode, denoise, VAE decode:
    an eager stage or its graph's replay), it records a pair of CUDA events
    (nothing off the card); :meth:`keep_marks` copies the denoise stage's
    stamps out behind it; :meth:`read` gives device ms by stage and, the
    first time, writes the ``stage.<name>`` records, and from the stamps
    ``stage.denoise.controlnet`` and ``stage.denoise.unet``."""

    def __init__(self, edit: Optional[int] = None, cuda: bool = False):
        self.edit, self.rows, self.cuda = edit, 0, cuda
        self.events: list = []  # (name, start, end)
        self.marks: Optional[tuple] = None  # (pinned host copy of the stamps, its event)
        self.ms: Optional[dict] = None

    def keep_marks(self, marks: torch.Tensor) -> None:
        """Copy the denoise stage's stamps (``stages.denoise``'s ``marks``)
        into pinned memory on the current stream, before a later replay can
        overwrite them."""
        host = torch.empty(marks.shape, dtype=marks.dtype, pin_memory=True)
        host.copy_(marks, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self.marks = (host, event)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.cuda:
            yield
            return
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        yield
        end.record()
        self.events.append((name, start, end))

    def read(self, wait: bool = True) -> dict:
        """Device ms by stage.  ``wait=False`` once the stream has passed
        the last event (the edit's copy to the host was waited for)."""
        if self.ms is None:
            ms = {}
            for name, start, end in self.events:
                if wait:
                    end.synchronize()
                ms[name] = ms.get(name, 0.0) + start.elapsed_time(end)
            self.ms = ms
            now = time.perf_counter_ns()
            for name, v in ms.items():
                profiling.record("stage." + name, now, now, edit=self.edit, rows=self.rows,
                                 device_ns=round(v * 1e6))
            if self.marks is not None:
                host, event = self.marks
                if wait:
                    event.synchronize()
                split = stages.denoise_split(host.tolist())
                for name, ns in zip(("controlnet", "unet"), split):
                    profiling.record("stage.denoise." + name, now, now, edit=self.edit,
                                     rows=self.rows, device_ns=ns)
        return self.ms


@dataclasses.dataclass
class _Part:
    first: int  # the batch's row of the part's first
    host: torch.Tensor  # uint8 [rows, r, r, 3], pinned on the card
    event: Optional[torch.cuda.Event]  # recorded after the copy into ``host``
    times: StageTimes


class PendingEdit:
    """Handle to an edit in flight: its images' copy to the host enqueued
    (into a fresh pinned buffer, behind the edit on the stream and so before
    any later edit can overwrite the graph's output), nothing waited for.
    ``result()`` waits for the copy and returns the PIL images, so a sweep
    can dispatch chunk i + 1 while chunk i's images come back.  Under data
    parallelism one handle joins the replicas' parts of a batch
    (:meth:`join`), each a run of rows from its ``first_row``."""

    def __init__(self, out: torch.Tensor, first_row: int = 0,
                 times: Optional[StageTimes] = None):
        times = StageTimes() if times is None else times
        with profiling.span("facade.readback_enqueue", edit=times.edit):
            event = None
            if out.is_cuda:
                with torch.cuda.device(out.device):
                    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                    host.copy_(out, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record()
            else:
                host = out
        self._parts = [_Part(first_row, host, event, times)]
        self._computed = self._parts
        self.batch = out.shape[0]
        self.edit = times.edit

    @classmethod
    def join(cls, parts: list, batch: int, computed: Optional[list] = None) -> "PendingEdit":
        """One handle for the rows of ``parts`` (handles of disjoint runs of
        rows) out of a batch of ``batch``; ``computed`` (default ``parts``)
        are the handles of every row this process computed, ``parts`` and
        the rows of groups another process owns."""
        def rows(handles):
            return sorted((p for h in handles for p in h._parts), key=lambda p: p.first)

        joined = cls.__new__(cls)
        joined._parts = rows(parts)
        joined._computed = rows(parts if computed is None else computed)
        joined.batch = batch
        joined.edit = next((h.edit for h in (computed or parts)), None)
        return joined

    def _images(self, parts: list) -> list:
        rows = []
        with profiling.span("facade.readback", edit=self.edit):
            for part in parts:
                if part.event is not None:
                    with profiling.span("facade.readback_wait", edit=self.edit):
                        part.event.synchronize()
                with profiling.span("facade.to_pil", edit=self.edit):
                    arr = part.host.numpy()
                    rows += [(part.first + i, Image.fromarray(arr[i]))
                             for i in range(arr.shape[0])]
                part.times.read(wait=False)  # the copy came after every stage
        return rows

    def stage_ms(self) -> dict:
        """Device ms per stage over every part this process computed,
        waiting only for a part not yet read back."""
        ms = {}
        for part in self._computed:
            for name, v in part.times.read().items():
                ms[name] = ms.get(name, 0.0) + v
        return ms

    def local_result(self) -> list:
        """``[(row, PIL image)]``, in row order, for the rows this process
        owns: every row of the batch, but under a data-parallel group that
        spans processes (``parallel/multihost.py``) only this process's."""
        return self._images(self._parts)

    def computed_result(self) -> list:
        """``[(row, PIL image)]``, in row order, for every row this process
        computed: its own, and those of a tensor-parallel group it holds a
        shard of whose rows another process owns (and saves)."""
        return self._images(self._computed)

    def result(self) -> list:
        """Every row's PIL image, in order; raises where another process
        holds some of them (use :meth:`local_result` there)."""
        rows = self.local_result()
        if len(rows) != self.batch:
            raise RuntimeError(
                f"this process holds {len(rows)} of the batch's {self.batch} rows, the "
                "others are another process's: use local_result()")
        return [img for _, img in rows]


class FastEditor:
    """Fast image editor: SDXL/SSD-1B + LCM + ControlNet-Canny on one card."""

    MODEL_CONFIGS = {
        "sdxl": {
            "base_model": "stabilityai/stable-diffusion-xl-base-1.0",
            "lcm_lora": "latent-consistency/lcm-lora-sdxl",
            "use_full_lcm": False,
            "unet_config": C.SDXL_UNET,
            "resolution": 1024,
            "description": "Full SDXL + fused LCM-LoRA",
        },
        "ssd-1b": {
            "base_model": "segmind/SSD-1B",
            "lcm_model": "latent-consistency/lcm-ssd-1b",
            "use_full_lcm": True,
            "unet_config": C.SSD1B_UNET,
            "resolution": 1024,
            "description": "SSD-1B distilled (50% smaller, faster)",
        },
        "tiny": {
            "use_full_lcm": True,
            "unet_config": C.TINY_UNET,
            "resolution": 64,
            "description": "Random-weight smoke model (tests/demo, real topology)",
        },
    }

    def __init__(
        self,
        model_name: str = "sdxl",
        device: Optional[str] = None,
        dtype=torch.bfloat16,
        enable_cpu_offload: bool = False,
        use_full_precision: bool = False,
        use_full_controlnet: bool = False,
        checkpoint_dir: Optional[str] = None,
        init_seed: int = 0,
        random_weights: bool = False,
    ):
        with profiling.span("facade.build"):
            if model_name not in self.MODEL_CONFIGS:
                raise ValueError(
                    f"Unknown model: {model_name}. Choose from {list(self.MODEL_CONFIGS)}"
                )
            self.model_name = model_name
            self.config = self.MODEL_CONFIGS[model_name]
            self.device = _resolve_device(device)
            self.dtype = torch.float32 if use_full_precision else _normalize_dtype(dtype)
            self.use_full_controlnet = use_full_controlnet
            self.enable_cpu_offload = enable_cpu_offload
            self.resolution = self.config["resolution"]
            if enable_cpu_offload:
                log.info(
                    "CPU offload requested but not needed: every weight stays in "
                    "the card's memory (SSD-1B and SDXL in bf16 fit one H100 by design)."
                )
            log.info("Initializing %s (%s)", model_name, self.config["description"])
            log.info("Device: %s, dtype: %s", self.device, str(self.dtype).replace("torch.", ""))
            with profiling.span("facade.init_weights"):
                if model_name == "tiny":
                    self._init_models(
                        C.TINY_UNET, C.TINY_CONTROLNET, C.TINY_VAE, C.TINY_TEXT_ENCODER,
                        C.TINY_TEXT_ENCODER_2,
                        torch.Generator(device=self.device).manual_seed(init_seed),
                    )
                    cn_ds = 2 ** (len(C.TINY_CONTROLNET.conditioning_embedding_channels) - 1)
                    self._control_res = self.resolution // C.TINY_VAE.downscale_factor * cn_ds
                elif random_weights:
                    cn_cfg = (C.SDXL_CONTROLNET_FULL if use_full_controlnet
                              else C.SDXL_CONTROLNET_SMALL)
                    self._init_models(
                        self.config["unet_config"], cn_cfg, C.SDXL_VAE, C.SDXL_TEXT_ENCODER,
                        C.SDXL_TEXT_ENCODER_2, None,
                    )
                    self._control_res = self.resolution
                else:
                    self._load_checkpoint(
                        checkpoint_dir or os.path.join("checkpoints", model_name))
            self.scheduler_config = LCMSchedulerConfig()
            self._init_runtime()

    def _init_runtime(self) -> None:
        """The caches, the CUDA graphs and the data-parallel group: empty."""
        self._prompt_cache: dict = {}
        self._schedule_cache: dict = {}
        self._const_cache: dict = {}
        self._graphs = graphs.EditGraphs(self.modules) if self.device.type == "cuda" else None
        self._last_times: Optional[StageTimes] = None  # the last edit's, for stage_ms()
        self._group = None
        # the last edit's final latents (on the graphs, the capture's buffer:
        # valid until the next edit, whatever its key)
        self.last_latents: Optional[torch.Tensor] = None

    def _init_models(self, unet_cfg, cn_cfg, vae_cfg, te1_cfg, te2_cfg, generator):
        dev, dt = self.device, self.dtype
        self.modules = stages.PipelineModules(
            unet=_build(UNet2DConditionModel, unet_cfg, dev, dt, generator),
            controlnet=_build(ControlNetModel, cn_cfg, dev, dt, generator),
            vae=_build(AutoencoderKL, vae_cfg, dev, dt, generator),
            text_encoder=_build(CLIPTextModel, te1_cfg, dev, dt, generator),
            text_encoder_2=_build(CLIPTextModel, te2_cfg, dev, dt, generator),
            vae_scaling_factor=vae_cfg.scaling_factor,
        )
        self.tokenizer = CLIPTokenizer.synthetic(vocab_size=te1_cfg.vocab_size)
        self.tokenizer_2 = CLIPTokenizer.synthetic(
            vocab_size=te2_cfg.vocab_size, pad_token_id=0
        )

    def _load_checkpoint(self, ckpt_dir: str) -> None:
        """Build the five models from a converted checkpoint directory
        (``utils/checkpoint.py``): each component's ``config.json`` and
        flat-key weights, copied to the device as stored, taken to the
        port's names and layouts there by ``tools/from_jax`` (the transposes
        run on the card, not the host) and cast to the model dtype as they
        are copied into the parameters; the tokenizers from ``tokenizer/``
        and ``tokenizer_2/``."""
        if not os.path.isdir(ckpt_dir):
            raise FileNotFoundError(
                f"Checkpoint directory not found: {ckpt_dir}. Convert the HF "
                "weights offline with tools/convert_checkpoint.py (this "
                "framework never downloads at runtime)."
            )
        cn_name = "controlnet_full" if self.use_full_controlnet else "controlnet"
        if not os.path.isdir(os.path.join(ckpt_dir, cn_name)):
            # No silent downgrade: a run asked to use the full ControlNet must
            # not quietly produce small-variant results attributed to it.
            raise FileNotFoundError(
                f"use_full_controlnet=True but {ckpt_dir}/{cn_name} is not "
                "converted. Convert it with tools/convert_checkpoint.py "
                "controlnet --src .../controlnet-canny-sdxl-1.0, or drop "
                "--full_controlnet to use the small variant."
            )
        dev, dt = self.device, self.dtype

        def load(component, cfg_cls, cls, to_state_dict):
            path = os.path.join(ckpt_dir, component)
            cfg = ckpt_io.load_config(path, cfg_cls)
            sd = to_state_dict(ckpt_io.load_params(path, device=dev), cfg)
            return cfg, _build(cls, cfg, dev, dt, state_dict=sd)

        t0 = time.perf_counter()
        _, unet = load("unet", C.UNetConfig, UNet2DConditionModel, from_jax.unet_state_dict)
        _, controlnet = load(cn_name, C.ControlNetConfig, ControlNetModel,
                             from_jax.controlnet_state_dict)
        vae_cfg, vae = load("vae", C.VAEConfig, AutoencoderKL, from_jax.vae_state_dict)
        _, te1 = load("text_encoder", C.CLIPTextConfig, CLIPTextModel,
                      from_jax.clip_text_state_dict)
        _, te2 = load("text_encoder_2", C.CLIPTextConfig, CLIPTextModel,
                      from_jax.clip_text_state_dict)
        self.modules = stages.PipelineModules(
            unet=unet, controlnet=controlnet, vae=vae, text_encoder=te1, text_encoder_2=te2,
            vae_scaling_factor=vae_cfg.scaling_factor,
        )
        self.tokenizer = CLIPTokenizer.from_dir(os.path.join(ckpt_dir, "tokenizer"))
        self.tokenizer_2 = CLIPTokenizer.from_dir(
            os.path.join(ckpt_dir, "tokenizer_2"), pad_token_id=0
        )
        self._control_res = self.resolution
        log.info("loaded %s in %.2f s", ckpt_dir, time.perf_counter() - t0)

    # --------------------------------------------------------- data parallel

    def enable_data_parallel(self, devices=None, model_parallel: int = 1):
        """Split later ``edit_batch[_async]`` calls over one replica per
        device, the counterpart of the JAX package's ICI data parallelism:
        ``devices`` defaults to this process's cards: every local card, or
        under ``parallel/multihost.initialize`` this process's share of its
        host's (``multihost.local_devices``, so the processes of a host
        split its cards); a list may name a device more than once
        (``["cpu", "cpu"]``).  This editor serves the first entry of its own
        device; every other replica is a ``FastEditor`` of the same
        configuration whose weights are copied from this editor's (not
        loaded or converted again), with its own caches, CUDA graphs and
        memory pool.  Where ``parallel/multihost.initialize`` has run, the
        group spans the processes: ``shape["data"]`` is the chunk size, one
        row per replica of every process, and each process edits only its
        own rows (``multihost.local_rows``).  Returns the group
        (``parallel/replicas.ReplicaGroup``).

        ``model_parallel = k > 1`` adds tensor parallelism (the JAX
        package's ``model`` mesh axis, ``parallel/tp.py``): every process's
        devices, rank-major, are taken in consecutive groups of ``k``, as
        the JAX package's ``make_mesh`` lays them (``multihost.members``),
        and each group holds one replica, a copy of this editor (whose own
        modules stay whole) with the UNet's and the ControlNet's transformer
        linears split over the group's devices; ``shape`` is ``{"data":
        world * n // k, "model": k}``.  A group may take devices of several
        processes: each process then holds a replica with its own shards,
        the members gather their partials over a gloo subgroup, every member
        computes the group's rows and the process of its first device owns
        them; when the group is built its members must hold the same
        weights, dtype and TF32 switches, or every member raises, naming the
        ranks that differ.  On the CPU the default list is this editor's
        device ``k / gcd(k, world)`` times: ``k`` times in one process, the
        fewest for ``k`` to divide every process's devices in several.  A
        device count that ``k`` does not divide over the processes raises,
        as ``make_mesh`` asserts.  Such a replica runs the caller's kernel
        flags, as any replica does; it captures CUDA graphs where its group
        is one card named ``k`` times in this process, and runs eagerly
        where the group spans cards or processes."""
        from fastedit_tpu_torch.parallel import multihost, tp
        from fastedit_tpu_torch.parallel.replicas import ReplicaGroup

        k = int(model_parallel)
        if k < 1:
            raise ValueError(f"model_parallel must be >= 1, got {model_parallel}")
        rank, world = multihost.rank_and_world()
        if devices is None:
            devices = (multihost.local_devices() if self.device.type == "cuda"
                       else [self.device] * (k // math.gcd(k, world)))
        devices = [_resolve_device(d) for d in devices]
        if (len(devices) * world) % k:
            over = f" in each of {world} processes" if world > 1 else ""
            raise ValueError(f"model_parallel={k} does not divide the {len(devices)} devices "
                             f"{[str(d) for d in devices]}{over}")
        layout = multihost.members(world, len(devices), k)
        mine = [(g, m) for g, m in enumerate(layout) if rank in multihost.ranks_of(m)]
        pgs = (multihost.subgroups(world, len(devices), k, rank)
               if multihost.groups_span(world, len(devices), k) else {})
        comms = {g: tp.GroupComm(pg, layout[g], rank) for g, pg in pgs.items()}
        if comms:  # before any copy: a member that differs fails fast
            state = (self.model_name, str(self.dtype), torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32,
                     tp.weights_checksum(getattr(self.modules, name) for name in
                                         ("unet", "controlnet", "vae", "text_encoder",
                                          "text_encoder_2")))
            for comm in comms.values():
                comm.agree(state, "the model, dtype, TF32 switches or replicated weights")
        replicas = []
        for g, m in mine:
            shards = tuple((s, devices[i]) for r, i, s in m if r == rank)
            if k > 1:
                replicas.append(self._tp_replica(tp.Placement(k, shards, comms.get(g))))
            else:
                own = shards[0][1] == self.device and self not in replicas
                replicas.append(self if own else self._replica(shards[0][1]))
        self._group = ReplicaGroup(replicas, rank, world, model_parallel=k, local=len(devices),
                                   groups=[g for g, _ in mine])
        log.info("Data parallelism enabled over %d replicas (%s), chunks of %d rows%s",
                 len(replicas), ", ".join(map(str, self._group.devices)),
                 self._group.shape["data"],
                 f"; tensor parallelism x{k} over {[str(d) for d in devices]}"
                 f"{f' x {world} processes' if world > 1 else ''}" if k > 1 else "")
        return self._group

    def _tp_replica(self, placement) -> "FastEditor":
        """A replica on the first device of ``placement`` (a
        ``parallel/tp.Placement``, or a list of devices) whose UNet and
        ControlNet transformer linears are split over it
        (``parallel/tp.py``); on CUDA graphs where every shard lies in this
        process on that one card, else eager."""
        from fastedit_tpu_torch.parallel import tp

        place = tp.Placement.of(placement)
        group = place.devices
        replica = self._replica(group[0])
        split = {name: tp.split_transformers(getattr(replica.modules, name), place)
                 for name in ("unet", "controlnet")}
        # the graphs' weight list, taken after the split; one capture cannot
        # span cards, nor hold the gloo collectives of a group over processes
        replica._graphs = (graphs.EditGraphs(replica.modules)
                           if replica._graphs is not None and place.comm is None
                           and set(group) == {group[0]} else None)
        log.info("Tensor parallelism x%d: shards %s on %s%s: %s", place.tp, place.shards,
                 ", ".join(map(str, group)),
                 f", ranks {place.comm.ranks}" if place.comm is not None else "", split)
        return replica

    def _replica(self, device: torch.device) -> "FastEditor":
        """A ``FastEditor`` on ``device`` with this one's configuration,
        tokenizers and a copy of its weights, and caches of its own."""
        replica = copy.copy(self)
        replica.device = device
        replica.modules = dataclasses.replace(self.modules, **{
            name: _build(type(m), m.config if hasattr(m, "config") else m.cfg, device,
                         self.dtype, state_dict=m.state_dict())
            for name in ("unet", "controlnet", "vae", "text_encoder", "text_encoder_2")
            for m in [getattr(self.modules, name)]})
        replica._init_runtime()
        return replica

    # ------------------------------------------------------------ preprocess

    def preprocess_image(
        self, image: Image.Image, low_threshold: int = 100, high_threshold: int = 200
    ) -> Image.Image:
        """PIL RGB -> Canny edge map as 3-channel RGB PIL (ControlNet input),
        through prepare's Canny kernel on the card (the plain version on the
        CPU)."""
        arr = torch.from_numpy(np.asarray(image.convert("RGB"), dtype=np.uint8).copy())
        low, high = canny.threshold_tensors(low_threshold, high_threshold, self.device)
        control, _ = stages.prepare(self.modules, arr[None].to(self.device), low, high,
                                    arr.shape[0])
        edges = (control[0] > 0).to(torch.uint8).mul_(255).cpu().numpy()
        return Image.fromarray(edges)

    # ------------------------------------------------------------------ edit

    def _stage_times(self, edit: Optional[int] = None) -> StageTimes:
        return StageTimes(edit, self.device.type == "cuda")

    def stage_ms(self) -> dict:
        """Device ms per stage of the last edit: CUDA events around prompt
        encoding (when a prompt was new), prepare, and each of VAE encode,
        denoise and VAE decode (an eager stage, or its graph's replay).
        Waits only where the last edit has not been read back.  Empty on the
        CPU."""
        return {} if self._last_times is None else dict(self._last_times.read())

    def _on_graphs(self) -> bool:
        """Replay CUDA graphs: on the card, unless the flags ask for the
        eager arm or the NaN checks (a host sync per stage) are on."""
        return self._graphs is not None and flags.use_cuda_graphs() and not nan_checks_enabled()

    def _encode_prompts(self, prompts, times: Optional[StageTimes] = None) -> None:
        """Encode every novel prompt in one call of the text encoders and
        cache a copy of each row.  The novel prompts, deduplicated, are padded
        to the next power of two with the last of them, as the JAX package
        pads them (a bounded set of shapes); on the card the padded batch is
        one replay of the prompt graph of its count
        (``graphs.EditGraphs.encode_prompts``), else it runs eagerly at the
        same count.  An fp32 editor encodes without TF32 here, not only inside
        an edit: a graph keeps what it was captured under.  ``times`` (the
        edit's :class:`StageTimes`) times the encoding on the card."""
        novel = list(dict.fromkeys(p for p in prompts if p not in self._prompt_cache))
        if not novel:
            return
        times = StageTimes() if times is None else times
        batch = novel + [novel[-1]] * (_next_pow2(len(novel)) - len(novel))
        with profiling.span("facade.encode_prompts", edit=times.edit, new_prompts=len(novel),
                            padded=len(batch)):
            with profiling.span("facade.tokenize", edit=times.edit):
                ids1 = torch.from_numpy(np.stack([self.tokenizer.encode(p) for p in batch])).long()
                ids2 = torch.from_numpy(
                    np.stack([self.tokenizer_2.encode(p) for p in batch])).long()
            with true_fp32() if self.dtype == torch.float32 else contextlib.nullcontext():
                if self._on_graphs():
                    ctx, pooled = self._graphs.encode_prompts(
                        graphs.prompt_key(len(batch)), ids1, ids2, times, edit=times.edit)
                else:
                    with times("encode_prompt"):
                        ctx, pooled = stages.encode_prompt(
                            self.modules, ids1.to(self.device), ids2.to(self.device))
            # copies, enqueued before any later replay overwrites the graph's outputs
            for i, p in enumerate(novel):
                self._prompt_cache[p] = (ctx[i : i + 1].clone(), pooled[i : i + 1].clone())
            while len(self._prompt_cache) > 4096:
                self._prompt_cache.pop(next(iter(self._prompt_cache)))

    def _schedule(self, num_inference_steps: int, strength: float):
        """The schedule, its table on the device; at most 64 kept."""
        key = (num_inference_steps, float(strength))
        if key not in self._schedule_cache:
            self._schedule_cache[key] = make_schedule(
                self.scheduler_config, num_inference_steps, strength=strength
            ).to(self.device)
            while len(self._schedule_cache) > 64:
                self._schedule_cache.pop(next(iter(self._schedule_cache)))
        return self._schedule_cache[key]

    def _const(self, kind: str, *args):
        """Small device constants, made once (at most 256 kept): time ids by
        batch, and the (guidance, ControlNet scale) tensors by value."""
        key = (kind, *args)
        if key not in self._const_cache:
            if kind == "time_ids":
                self._const_cache[key] = stages.make_sdxl_time_ids(
                    args[0], self.resolution, self.device)
            elif kind == "scalars":
                self._const_cache[key] = stages.edit_scalars(self.modules, *args, self.device)
            else:
                raise KeyError(kind)
            while len(self._const_cache) > 256:
                self._const_cache.pop(next(iter(self._const_cache)))
        return self._const_cache[key]

    def _noise(self, seed: int, shape, num_steps: int):
        """(posterior eps, initial noise, one noise per step), fp32 standard
        normals of ``shape`` from one seeded generator on the device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        draws = [
            torch.randn(shape, generator=gen, device=self.device)
            for _ in range(num_steps + 2)
        ]
        return draws[0], draws[1], draws[2:]

    def stage_inputs(self, images):
        """A pre-resized uint8 batch [B, r, r, 3] on the device, ahead of
        the edit: from pinned memory with a non-blocking copy, so a sweep's
        loader thread can stage chunk i + 1 while chunk i computes.  Pass
        the tensor to ``edit_batch[_async]`` in place of the array.  Under
        data parallelism each replica's rows go to its device (a
        ``parallel/replicas.Staged``)."""
        with profiling.span("facade.stage", rows=len(images)):
            if self._group is not None:
                return self._group.stage(images)
            return self._stage_inputs(images)

    def _stage_inputs(self, images) -> torch.Tensor:
        img_u8 = np.ascontiguousarray(images, dtype=np.uint8)
        r = self.resolution
        if img_u8.ndim != 4 or img_u8.shape[1:] != (r, r, 3):
            raise ValueError(
                f"staged batch must have shape (B, {r}, {r}, 3); got {img_u8.shape}"
            )
        if self.device.type != "cuda":
            return torch.from_numpy(img_u8.copy())
        host = torch.empty(img_u8.shape, dtype=torch.uint8, pin_memory=True)
        host.numpy()[...] = img_u8
        return host.to(self.device, non_blocking=True)

    def _device_batch(self, images) -> torch.Tensor:
        """uint8 [B, r, r, 3] on the device from a staged tensor, a
        pre-resized uint8 array or a list of PIL images."""
        r = self.resolution
        if isinstance(images, torch.Tensor):
            if (tuple(images.shape[1:]) != (r, r, 3) or images.dtype != torch.uint8
                    or images.device != self.device):
                raise ValueError(
                    f"staged batch must be uint8 of shape (B, {r}, {r}, 3) on "
                    f"{self.device}; got {images.dtype} {tuple(images.shape)} on "
                    f"{images.device}"
                )
            return images
        if isinstance(images, np.ndarray):
            if images.shape[1:] != (r, r, 3) or images.dtype != np.uint8:
                raise ValueError(
                    f"pre-resized batch must be uint8 of shape (B, {r}, {r}, 3); "
                    f"got {images.dtype} {images.shape}"
                )
            return self._stage_inputs(images)
        return self._stage_inputs(np.stack(
            [np.asarray(resize(im.convert("RGB"), r), dtype=np.uint8) for im in images]
        ))

    def _run_edit(
        self, images, prompts, negative_prompt, strength, num_inference_steps,
        guidance_scale, controlnet_conditioning_scale, canny_low_threshold,
        canny_high_threshold, seed, tile_noise: bool, times: Optional[StageTimes] = None,
    ) -> torch.Tensor:
        """Shared single/batch path; returns uint8 [B, r, r, 3] on the
        device (on the card, a graph's output buffer: copy it before the
        next edit).  ``times`` (a :class:`StageTimes`) times its stages and
        carries its edit id.  An fp32 editor runs it all without TF32."""
        with true_fp32() if self.dtype == torch.float32 else contextlib.nullcontext():
            return self._run_edit_body(
                images, prompts, negative_prompt, strength, num_inference_steps,
                guidance_scale, controlnet_conditioning_scale, canny_low_threshold,
                canny_high_threshold, seed, tile_noise, StageTimes() if times is None else times)

    def _run_edit_body(
        self, images, prompts, negative_prompt, strength, num_inference_steps,
        guidance_scale, controlnet_conditioning_scale, canny_low_threshold,
        canny_high_threshold, seed, tile_noise: bool, times: StageTimes,
    ) -> torch.Tensor:
        do_cfg = guidance_scale > 1.0
        self._encode_prompts(list(prompts) + ([negative_prompt] if do_cfg else []), times)
        with profiling.span("facade.inputs", edit=times.edit):
            inputs = self._device_batch(images)
            b, r = inputs.shape[0], self.resolution
            enc = [self._prompt_cache[p] for p in prompts]
            ctx_c = torch.cat([e[0] for e in enc])
            pooled_c = torch.cat([e[1] for e in enc])
            if do_cfg:  # pair-interleaved (u_i, c_i)
                ctx_u, pooled_u = self._prompt_cache[negative_prompt]
                context = torch.stack([ctx_u.expand_as(ctx_c), ctx_c], dim=1).reshape(
                    2 * b, *ctx_c.shape[1:]
                )
                pooled = torch.stack([pooled_u.expand_as(pooled_c), pooled_c], dim=1).reshape(
                    2 * b, *pooled_c.shape[1:]
                )
            else:
                context, pooled = ctx_c, pooled_c
            schedule = self._schedule(num_inference_steps, strength)

            if seed is None:
                seed = int.from_bytes(os.urandom(4), "little")
            # At batch 1 the tiled and untiled draws are the same: one graph key.
            tile_noise = tile_noise and b > 1
            lat_shape = (1 if tile_noise else b, r // 8, r // 8, 4)
            eps_enc, noise_init, step_noise = self._noise(seed, lat_shape, schedule.num_steps)
            guidance, cn_scale = self._const(
                "scalars", float(guidance_scale), float(controlnet_conditioning_scale))

            low, high = canny.threshold_tensors(canny_low_threshold, canny_high_threshold,
                                                self.device)
            inp = graphs.EditInputs(
                inputs, low, high, eps_enc, noise_init, tuple(step_noise), context, pooled,
                self._const("time_ids", context.shape[0]), schedule, guidance, cn_scale, do_cfg,
                self._control_res,
            )
            key = (graphs.graph_key(b, do_cfg, schedule.num_steps, tile_noise, r)
                   if self._on_graphs() else None)
        times.rows = b
        if key is not None:
            self.last_latents, out = self._graphs.run(key, inp, times, edit=times.edit)
        else:
            self.last_latents, out = graphs.run_eager(self.modules, inp, times)
        return out

    def edit(
        self,
        image: Image.Image,
        prompt: str,
        negative_prompt: str = "",
        strength: float = 0.80,
        num_inference_steps: int = 4,
        guidance_scale: float = 1.5,
        controlnet_conditioning_scale: float = 0.5,
        canny_low_threshold: int = 100,
        canny_high_threshold: int = 200,
        seed: Optional[int] = None,
    ) -> Image.Image:
        """Edit ``image`` per ``prompt``; returns the edited PIL image."""
        times = self._stage_times(next(_EDIT_IDS))
        out = self._run_edit(
            [image], [prompt], negative_prompt, strength, num_inference_steps,
            guidance_scale, controlnet_conditioning_scale, canny_low_threshold,
            canny_high_threshold, seed, tile_noise=False, times=times,
        )
        return self._pending(out, 0, times).result()[0]

    def edit_batch(self, images, prompts: list, **kw) -> list:
        """Edit a batch in one pass: a list of PIL images, a pre-resized
        uint8 array [B, r, r, 3] or ``stage_inputs``'s tensor, with one
        prompt each; keywords as :meth:`edit`'s.  With a fixed ``seed``
        every image gets the same noise stream, as with same-seeded
        per-image generators."""
        return self.edit_batch_async(images, prompts, **kw).result()

    def edit_batch_async(
        self,
        images,
        prompts: list,
        negative_prompt: str = "",
        strength: float = 0.80,
        num_inference_steps: int = 4,
        guidance_scale: float = 1.5,
        controlnet_conditioning_scale: float = 0.5,
        canny_low_threshold: int = 100,
        canny_high_threshold: int = 200,
        seed: Optional[int] = None,
    ) -> PendingEdit:
        """Like ``edit_batch``, but returns a :class:`PendingEdit` without
        waiting for the images.  Under data parallelism the rows are split
        over the replicas, each replica's dispatched without waiting for the
        others."""
        if len(images) != len(prompts) or len(images) == 0:
            raise ValueError("edit_batch needs as many prompts as images (>= 1)")
        kw = dict(negative_prompt=negative_prompt, strength=strength,
                  num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
                  controlnet_conditioning_scale=controlnet_conditioning_scale,
                  canny_low_threshold=canny_low_threshold,
                  canny_high_threshold=canny_high_threshold, seed=seed,
                  edit=next(_EDIT_IDS))
        if self._group is not None:
            return self._group.edit_batch_async(images, prompts, kw)
        return self._dispatch(images, prompts, kw)

    def _dispatch(self, images, prompts, kw: dict, first_row: int = 0) -> PendingEdit:
        """This editor's edit of ``images`` (rows ``first_row`` on of a
        batch), not waited for.  Every row takes the same noise stream where
        the caller fixed the seed; ``kw["tile_noise"]`` (False) keeps a
        seed drawn for the caller (``parallel/replicas.py``) untiled;
        ``kw["edit"]`` is the call's id (a new one without it)."""
        kw = dict(kw)
        tile_noise = kw.pop("tile_noise", kw["seed"] is not None)
        edit = kw.pop("edit", None)
        times = self._stage_times(next(_EDIT_IDS) if edit is None else edit)
        out = self._run_edit(images, prompts, **kw, tile_noise=tile_noise, times=times)
        return self._pending(out, first_row, times)

    def _pending(self, out: torch.Tensor, first_row: int, times: StageTimes) -> PendingEdit:
        self._last_times = times
        return PendingEdit(out, first_row, times)

    # ----------------------------------------------------------------- misc

    def clear_memory(self):
        """Drop cached prompt embeddings, schedules, constants and the CUDA
        graphs with their memory pool, this editor's and its replicas'
        (weights stay)."""
        self._prompt_cache.clear()
        self._schedule_cache.clear()
        self._const_cache.clear()
        if self._graphs is not None:
            self._graphs.clear()
        self.last_latents = None
        for replica in self._group.replicas if self._group is not None else ():
            if replica is not self:
                replica.clear_memory()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def get_memory_usage(self):
        """Device memory in GiB: allocated, reserved and peak allocated."""
        if self.device.type != "cuda":
            return {"allocated_gb": 0.0, "reserved_gb": 0.0, "peak_gb": 0.0}
        gib = 1024**3
        return {
            "allocated_gb": torch.cuda.memory_allocated(self.device) / gib,
            "reserved_gb": torch.cuda.memory_reserved(self.device) / gib,
            "peak_gb": torch.cuda.max_memory_allocated(self.device) / gib,
        }

    def warmup(self, **edit_kwargs):
        """One dummy edit (builds the kernels on first use and, on the card,
        captures the edit's graphs); returns seconds."""
        dummy = Image.new("RGB", (self.resolution, self.resolution), (128, 128, 128))
        t0 = time.time()
        edit_kwargs.setdefault("seed", 0)
        self.edit(dummy, "warmup", **edit_kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.time() - t0
