"""fp32 that is fp32 on the card: TF32 off for matmuls and cuDNN convs.

PyTorch runs an fp32 cuDNN convolution in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
decimal digits; the fp32 edit (the quality mode) and the metrics are fp32
references and run inside :func:`true_fp32`.  Only the legacy ``allow_tf32``
switches are used: torch 2.13 raises on ``get_float32_matmul_precision()``
once the legacy and the new ``fp32_precision`` API were mixed.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def true_fp32():
    """fp32 matmuls and cuDNN convs without TF32 inside; the previous
    settings come back on exit.  The counterpart of the JAX package's
    ``jax.default_matmul_precision("highest")``.  The switches are the
    process's, not the thread's."""
    backends = torch.backends
    old = backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32
    backends.cuda.matmul.allow_tf32 = backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32 = old
