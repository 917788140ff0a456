"""The kernel plan: which calls go to a hand-written kernel, per stage.

Every hot op has a hand-written CUDA kernel and a plain PyTorch version of
the same function.  The dispatchers (``ops/conv.py``, ``ops/attention.py``,
``ops/groupnorm.py``, ``ops/layer_norm.py`` and the conv modules of
``models/resnet.py``) and ``tools/inventory.route`` ask :func:`takes`
whether a call goes to a kernel: it does where the plan of the stage it
runs in has the kernel and the kernel's own gate (its ``supports``) admits
the call.  Otherwise PyTorch's own op (cuDNN's conv, the plain GroupNorm or
attention) runs it, as the JAX package sends it to XLA.  A wrapper launches
its kernel for a CUDA tensor or raises; it runs the plain version only for
a CPU tensor.

The plan (:data:`PLAN`) is the JAX package's defaults on its accelerator
(``fastedit_tpu/ops/flags.py``), but one.  The conv rows come from that
package's TPU measurements:

  * denoise loop (UNet, ControlNet and its conditioning tower): the conv
    kernel, up2 (K3) and down2 (K4); whole-resnet fusion (K5) off;
  * VAE decoder: the conv kernel, K5 and K3;
  * VAE encoder and any module run outside a stage: no conv kernel.

Flash attention, the cross-attention kernel, LayerNorm and Canny run
wherever their gates admit the call.  So does the GroupNorm kernel (K7, and
its statistics launch for K5's prologue), the port's one departure from the
JAX defaults, where it is opt-in, and the one row from the port's own A/B.
There "off" is one fused XLA program per GroupNorm; eager PyTorch has no
such path (off is a dozen eager kernels over fp32 copies), and on an H100
80GB HBM3 at 700 W the SSD-1B edit at 1024² took 138 instead of 230 device
ms and 0.296 instead of 0.407 s (medians of 7) with the kernel on
(``tools/profile_edit.py``, the two arms in turns).

The gates do not depend on the dtype, a second departure: the JAX package
passes the item size to its gates, and at fp32 (the quality mode) its VMEM
tile budget refuses 17 more calls per SSD-1B edit at 1024² than at bf16 (8
of the VAE decoder's fused resnet convs, 9 of the UNet's up-block convs with
1920 or 2560 input channels), which then run in XLA.  That budget is the
TPU's: in fp32 the port sends every call its gates admit to the kernel's
fp32 instance, the same calls and counts as in bf16 (``tools/inventory.py``;
``tests/test_torch_f32.py`` holds the difference to exactly those calls).
One gate does read the dtype: the cross-attention kernel (the UNet's
attention to the text tokens, which the JAX package sends to XLA at any item
size) takes bf16 only; fp32 cross-attention keeps the plain version.

The stage functions enter their stage with :func:`stage`.  PyTorch runs
eagerly, so the plan is read when the op runs, not when a program is traced.

Two flags choose the arm an edit runs on, nothing else:

``plain_versions`` is the counterpart of the JAX package's
``pallas_interpret``: with it, every call that would launch a kernel runs
the kernel's plain version instead, on any device, so an edit can be held
against the same edit without kernels (``chip_smoke.py``).

``cuda_graphs`` is the counterpart of ``jax.disable_jit`` (set to False):
on, the editor replays its pixel path as CUDA graphs on the card
(``pipeline/graphs.py``), as the JAX package runs it as jitted programs;
off, it runs the same stages eagerly, op by op (the arm the graphs are held
against).  Graphs run only with both flags at their defaults, so a capture
is keyed by its shapes alone (``graphs.graph_key``).  A tensor-parallel
replica whose group spans several cards or several processes
(``parallel/tp.py``) runs eagerly whatever this flag says: one capture
cannot span cards, and a group over processes sums its partials through
gloo collectives inside the denoise stage, host work that no capture can
hold.

The flags and the stage are per thread: every thread starts from the
defaults below, outside any stage, and sees only its own :func:`override`s,
as the JAX package's flags are read at trace time by the one thread that
traces.  A replica or a server's worker thread can run its own arm without
moving another thread's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import threading
from typing import Optional


@dataclasses.dataclass
class KernelFlags:
    plain_versions: bool = False  # kernels' plain versions in their place
    cuda_graphs: bool = True  # the editor's pixel path as CUDA graphs on the card


class _ThreadFlags(KernelFlags, threading.local):
    """``KernelFlags`` with one copy per thread, each made from the
    defaults on the thread's first read."""

    def __eq__(self, other):
        return isinstance(other, KernelFlags) and (
            dataclasses.astuple(self) == dataclasses.astuple(other))


FLAGS = _ThreadFlags()
_STAGE = threading.local()

# The conv kernels each stage's plan turns on; no conv kernel runs outside a
# stage.  Every other kernel runs in every stage, where its gate admits the call.
PLAN = {
    "encode": frozenset(),
    "denoise": frozenset({"conv3x3", "conv3x3_up2", "conv3x3_down2"}),
    "decode": frozenset({"conv3x3", "conv3x3_fused", "conv3x3_up2"}),
}
STAGES = tuple(PLAN)
CONV_KERNELS = ("conv3x3", "conv3x3_fused", "conv3x3_up2", "conv3x3_down2")

# kernel -> (its module under ops/, its gate)
GATES = {
    "conv3x3": ("conv3x3", "supports"),
    "conv3x3_fused": ("conv_fused", "supports_fused"),
    "conv3x3_up2": ("conv_fused", "supports_up2"),
    "conv3x3_down2": ("conv_fused", "supports_down2"),
    "group_norm": ("fused_groupnorm", "supports"),
    "group_norm_scale_shift": ("fused_groupnorm", "supports"),
    "flash_attention": ("flash_attention", "supports"),
    "cross_attention": ("flash_attention", "supports_cross"),
    "layer_norm": ("layer_norm", "supports"),
}


def current() -> KernelFlags:
    """The calling thread's flags, as a plain (unshared) ``KernelFlags``."""
    return KernelFlags(*dataclasses.astuple(FLAGS))


def current_stage() -> Optional[str]:
    """The stage the calling thread runs in, or None outside one."""
    return getattr(_STAGE, "name", None)


def takes(kernel: str, *call) -> bool:
    """Whether a call goes to ``kernel``: the current stage's plan has it,
    and its gate admits ``call`` (the gate's arguments: the shapes, and the
    dtype where the gate reads it)."""
    if kernel in CONV_KERNELS and kernel not in PLAN.get(current_stage(), ()):
        return False
    module, gate = GATES[kernel]
    return getattr(importlib.import_module(f"fastedit_tpu_torch.ops.{module}"), gate)(*call)


def use_cuda_graphs() -> bool:
    """Replay the pixel path as CUDA graphs (on a card; never with the
    plain versions, which are for comparisons)."""
    return FLAGS.cuda_graphs and not FLAGS.plain_versions


def kernel_or_plain(kernel, plain):
    """``kernel`` (a wrapper), or its plain version where
    ``plain_versions`` selects it."""
    return plain if FLAGS.plain_versions else kernel


@contextlib.contextmanager
def stage(name: str):
    """Run the body in stage ``name``, under its plan."""
    if name not in PLAN:
        raise ValueError(f"unknown stage {name!r}; one of {STAGES}")
    old = current_stage()
    _STAGE.name = name
    try:
        yield
    finally:
        _STAGE.name = old


@contextlib.contextmanager
def override(**kwargs):
    """Temporarily override kernel flags in the calling thread; an unknown
    name raises."""
    old = current()
    names = {f.name for f in dataclasses.fields(KernelFlags)}
    try:
        for k, v in kwargs.items():
            if k not in names:
                raise AttributeError(f"unknown kernel flag {k!r}")
            setattr(FLAGS, k, v)
        yield
    finally:
        for f in dataclasses.fields(KernelFlags):
            setattr(FLAGS, f.name, getattr(old, f.name))
