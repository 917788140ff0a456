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
import threading

import torch

# The switches are the process's, and data-parallel replicas edit on worker
# threads: the first entry saves and clears them, the last exit restores them,
# and entries in between only count.
_lock = threading.Lock()
_depth = 0
_saved: tuple[bool, bool] = (False, False)


@contextlib.contextmanager
def true_fp32():
    """fp32 matmuls and cuDNN convs without TF32 inside; the settings from
    before the first entry come back at the last exit.  The counterpart of the
    JAX package's ``jax.default_matmul_precision("highest")``, which is
    thread-local; PyTorch's switches are the process's, so the rule here is
    that no thread's fp32 work runs in TF32 while any thread is inside: the
    switches stay off until every thread has left."""
    global _depth, _saved
    backends = torch.backends
    with _lock:
        if _depth == 0:
            _saved = backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32
            backends.cuda.matmul.allow_tf32 = backends.cudnn.allow_tf32 = False
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32 = _saved
