"""Kernel-dispatch flags, resolved per context as in the JAX package.

Every hot op has a hand-written CUDA kernel and a plain PyTorch version of
the same function.  The dispatchers (``ops/conv.py``, ``ops/attention.py``,
``ops/groupnorm.py`` and the conv modules of ``models/resnet.py``) send a
call inside a kernel's gate to the kernel's wrapper when the flags below
turn the kernel on, and to PyTorch's own op (cuDNN's conv, the plain
GroupNorm) when they turn it off, as the JAX package sends it to XLA.  A
wrapper launches its kernel for a CUDA tensor or raises; it runs the plain
version only for a CPU tensor.

The fields mirror ``fastedit_tpu/ops/flags.py`` (``use_pallas_*`` becomes
``use_cuda_*``); ``None`` means the context's default, and the defaults
are the JAX package's values on its accelerator, but one:

  * denoise loop (UNet, ControlNet and its conditioning tower): conv
    kernel on, up2 (K3) on, down2 (K4) on, whole-resnet fusion (K5) off;
  * VAE decoder: conv kernel on, K5 on, K3 on;
  * VAE encoder and any module run outside a stage: no conv kernel.
  * flash attention: on.
  * GroupNorm kernel (K7, and its statistics launch for K5's prologue): on,
    the port's one departure from the JAX defaults, where it is opt-in.
    There "off" is one fused XLA program per GroupNorm; eager PyTorch has no
    such path (off is a dozen eager kernels over fp32 copies), and on an
    H100 80GB HBM3 at 700 W the SSD-1B edit at 1024² took 138 instead of
    230 device ms and 0.296 instead of 0.407 s (medians of 7) with the
    kernel on (``tools/profile_edit.py``, the two arms in turns).

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

The stage functions enter their context with :func:`stage`.  PyTorch runs
eagerly, so a flag is read when the op runs, not when a program is traced.

``plain_versions`` is the counterpart of the JAX package's
``pallas_interpret``: with it, every call that would launch a kernel runs
the kernel's plain version instead, on any device, so an edit can be held
against the same edit without kernels (``chip_smoke.py``).

``cuda_graphs`` is the counterpart of ``jax.disable_jit`` (set to False):
on, the editor replays its pixel path as CUDA graphs on the card
(``pipeline/graphs.py``), as the JAX package runs it as jitted programs;
off, it runs the same stages eagerly, op by op (the arm the graphs are held
against).  A graph is captured under the flags in force and keyed by all
of them (``graphs.graph_key``).  ``plain_versions`` runs eagerly too, and so
does a tensor-parallel replica whose group spans several cards or several
processes (``parallel/tp.py``), whatever this flag says: one capture cannot
span cards, and a group over processes sums its partials through gloo
collectives inside the denoise stage, host work that no capture can hold.

The flags are per thread: every thread starts from the defaults below and
sees only its own :func:`override`s, as the JAX package's flags are read
at trace time by the one thread that traces.  A replica or a server's
worker thread can run its own configuration without moving another
thread's (nor another thread's graph key, which :func:`current` reads).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional


@dataclasses.dataclass
class KernelFlags:
    use_cuda_attention: Optional[bool] = None  # None = on
    use_cuda_groupnorm: Optional[bool] = None  # None = on (the JAX package: off)
    use_cuda_conv: Optional[bool] = None  # None = the context's default
    use_fused_resnet: Optional[bool] = None  # None = the context's default
    use_fused_up2: Optional[bool] = None  # None = the context's default
    use_fused_down2: Optional[bool] = None  # None = the context's default
    plain_versions: bool = False  # kernels' plain versions in their place
    cuda_graphs: bool = True  # the editor's pixel path as CUDA graphs on the card


class _ThreadFlags(KernelFlags, threading.local):
    """``KernelFlags`` with one copy per thread, each made from the
    defaults on the thread's first read."""

    def __eq__(self, other):
        return isinstance(other, KernelFlags) and (
            dataclasses.astuple(self) == dataclasses.astuple(other))


FLAGS = _ThreadFlags()


def current() -> KernelFlags:
    """The calling thread's flags, as a plain (unshared) ``KernelFlags``."""
    return KernelFlags(*dataclasses.astuple(FLAGS))


def _or(value: Optional[bool], default: bool) -> bool:
    return default if value is None else value


def use_cuda_attention() -> bool:
    return _or(FLAGS.use_cuda_attention, True)


def use_cuda_groupnorm() -> bool:
    return _or(FLAGS.use_cuda_groupnorm, True)


def use_cuda_graphs() -> bool:
    """Replay the pixel path as CUDA graphs (on a card; never with the
    plain versions, which are for comparisons)."""
    return FLAGS.cuda_graphs and not FLAGS.plain_versions


def kernel_or_plain(kernel, plain):
    """``kernel`` (a wrapper), or its plain version where
    ``plain_versions`` selects it."""
    return plain if FLAGS.plain_versions else kernel


def use_cuda_conv() -> bool:
    """The conv kernel in the current context.  Outside a stage (and in
    the VAE encoder) it is off unless set: the JAX package measured XLA's
    conv faster there on its accelerator and kept it."""
    return _or(FLAGS.use_cuda_conv, False)


def use_cuda_conv_denoise() -> bool:
    return _or(FLAGS.use_cuda_conv, True)


def use_cuda_conv_decode() -> bool:
    return _or(FLAGS.use_cuda_conv, True)


def use_cuda_conv_encode() -> bool:
    return _or(FLAGS.use_cuda_conv, False)


def use_fused_resnet() -> bool:
    """Whole-resnet-block fusion (``ops/conv_fused.conv3x3_fused``)."""
    return _or(FLAGS.use_fused_resnet, use_cuda_conv())


def use_fused_up2() -> bool:
    """Nearest-2x upsample + conv in one kernel (``conv3x3_up2``)."""
    return _or(FLAGS.use_fused_up2, use_cuda_conv())


def use_fused_down2() -> bool:
    """Stride-2 conv kernel (``conv3x3_down2``)."""
    return _or(FLAGS.use_fused_down2, use_cuda_conv())


def resolve_fused_encode() -> tuple[bool, bool]:
    """(use_fused_resnet, use_fused_down2) in the VAE encoder; the encode
    context's conv flag gates both."""
    on = use_cuda_conv_encode()
    return _or(FLAGS.use_fused_resnet, on) and on, _or(FLAGS.use_fused_down2, on) and on


def resolve_fused_denoise() -> tuple[bool, bool]:
    """(use_fused_resnet, use_fused_up2) in the denoise loop: resnet fusion
    off unless set, up2 following the context's conv flag, both gated by
    it (the fusions live inside the conv kernel)."""
    on = use_cuda_conv_denoise()
    return _or(FLAGS.use_fused_resnet, False) and on, _or(FLAGS.use_fused_up2, on) and on


def resolve_fused_down2_denoise() -> bool:
    """conv3x3_down2 for the downsamplers of the denoise loop."""
    on = use_cuda_conv_denoise()
    return _or(FLAGS.use_fused_down2, on) and on


def resolve_fused_decode() -> tuple[bool, bool]:
    """(use_fused_resnet, use_fused_up2) in the VAE decoder."""
    on = use_cuda_conv_decode()
    return _or(FLAGS.use_fused_resnet, on) and on, _or(FLAGS.use_fused_up2, on) and on


STAGES = ("encode", "denoise", "decode")


def stage_overrides(name: str) -> dict:
    """The flag values a stage runs under, as the JAX package's stages set
    them around their bodies."""
    if name == "denoise":
        resnet, up2 = resolve_fused_denoise()
        return dict(use_cuda_conv=use_cuda_conv_denoise(), use_fused_resnet=resnet,
                    use_fused_up2=up2, use_fused_down2=resolve_fused_down2_denoise())
    if name == "decode":
        resnet, up2 = resolve_fused_decode()
        return dict(use_cuda_conv=use_cuda_conv_decode(), use_fused_resnet=resnet,
                    use_fused_up2=up2)
    if name == "encode":
        resnet, down2 = resolve_fused_encode()
        return dict(use_cuda_conv=use_cuda_conv_encode(), use_fused_resnet=resnet,
                    use_fused_down2=down2)
    raise ValueError(f"unknown stage {name!r}; one of {STAGES}")


@contextlib.contextmanager
def stage(name: str):
    """Run the body in stage ``name``'s kernel context."""
    with override(**stage_overrides(name)):
        yield


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
