"""Device timestamps for the program's tracing: the wrapper of
``csrc/stamp.cu``.

:func:`stamp` enqueues one one-thread launch on the current stream that
writes the card's ``%globaltimer`` (ns) into ``buf[slot]`` when the stream
reaches it, eagerly or inside a CUDA graph's capture alike.  The denoise
stage stamps each step's ControlNet start, UNet start and UNet end into a
buffer the editor owns (``pipeline/stages.py``, ``pipeline/graphs.py``);
differences of two stamps are device ns between two points of one stream.
It computes nothing of the edit, so it has no plain version: off the card
nothing is stamped.
"""

from __future__ import annotations

import torch

# Launches since the last reset, as the kernels' wrappers count theirs.
launches = 0


def stamp(buf: torch.Tensor, slot: int) -> None:
    """Write the card's clock into ``buf[slot]`` (``buf`` int64 on the
    card) once the work enqueued before it on the current stream is done."""
    if not buf.is_cuda or buf.dtype != torch.int64 or not buf.is_contiguous():
        raise ValueError("stamp: buf must be a contiguous int64 tensor on the card")
    if not 0 <= slot < buf.numel():
        raise IndexError(f"stamp: slot {slot} outside a buffer of {buf.numel()}")
    from fastedit_tpu_torch.ops.build import library

    with torch.cuda.device(buf.device):
        err = library("stamp").device_stamp(
            buf.data_ptr(), slot, torch.cuda.current_stream(buf.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"device_stamp launch failed: CUDA error {err}")
    global launches
    launches += 1
