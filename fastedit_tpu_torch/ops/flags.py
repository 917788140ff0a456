"""Kernel-dispatch flags.

Every hot op has a hand-written CUDA kernel and a plain PyTorch version of
the same function.  The dispatchers (``ops/conv.py``, ``ops/attention.py``)
send a call inside a kernel's gate to the kernel's wrapper, which launches
the kernel for a CUDA tensor and runs the plain version for a CPU tensor.
A CUDA tensor never falls back silently: the wrapper launches or raises.

The flags below only exist to select the plain versions explicitly, on any
device, for comparisons (``chip_smoke.py``'s kernels-vs-plain edit and the
tests).  Nothing on the main path sets them.

This slice's configuration is the JAX package's "bare Pallas convs" arm:
the conv kernel on in every context (denoise loop, VAE decoder, VAE
encoder), flash attention on, and no fused kernels (the fused resnet, up2
and down2 convs and the GroupNorm kernel are later slices).  The JAX
package's per-context conv switches come with the slice that first gives
the contexts different values.  PyTorch runs eagerly, so a flag is read
when the op runs, not when a program is traced.
"""

from __future__ import annotations

import contextlib
import dataclasses


@dataclasses.dataclass
class KernelFlags:
    use_cuda_conv: bool = True
    use_cuda_attention: bool = True


FLAGS = KernelFlags()


def use_cuda_conv() -> bool:
    return FLAGS.use_cuda_conv


def use_cuda_attention() -> bool:
    return FLAGS.use_cuda_attention


@contextlib.contextmanager
def override(**kwargs):
    """Temporarily override kernel flags (comparisons and tests)."""
    old = dataclasses.replace(FLAGS)
    try:
        for k, v in kwargs.items():
            if not hasattr(FLAGS, k):
                raise AttributeError(f"unknown kernel flag {k!r}")
            setattr(FLAGS, k, v)
        yield
    finally:
        for f in dataclasses.fields(KernelFlags):
            setattr(FLAGS, f.name, getattr(old, f.name))
