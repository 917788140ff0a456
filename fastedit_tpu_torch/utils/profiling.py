"""Tracing, stage timing, memory and NaN checks (the counterpart of the JAX
package's ``utils/profiling.py``).

* :func:`sync` waits for the card's work on every tensor of a nested
  structure; :class:`StageTimer` times named stages on the host clock after
  such a wait, with the JAX package's API and report.
* :func:`trace` runs ``torch.profiler`` (CPU and, on the card, CUDA
  activity) around its body and writes a Chrome trace into a directory.
* :func:`device_memory_stats`: the same three keys as the JAX package's.
* :func:`enable_nan_checks`: the counterpart of ``jax_debug_nans``, a
  process-wide switch as that config is.  While it is on the editor runs
  its eager arm (no CUDA graph is captured with the checks in it) and
  :func:`check_finite` raises ``FloatingPointError`` at the first stage
  output (prompt encode, prepare, VAE encode, each denoise step, VAE decode
  before its clip) that holds a NaN or an infinity.  Off, a check is one
  Python test and no device work, so the stages stay capturable.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

_NAN_CHECKS = False


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def sync(tree) -> None:
    """Wait for the card's work on every CUDA tensor in ``tree`` (nested
    lists, tuples and dicts): one ``torch.cuda.synchronize`` per device."""
    for device in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(device)


class StageTimer:
    """Accumulates wall time per named stage; prints a table on report()."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        out = {}
        yield out
        if "result" in out:
            sync(out["result"])
        elif result is not None:
            sync(result)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = ["stage                    total_s   calls   avg_ms"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            c = self.counts[name]
            lines.append(f"{name:<24} {total:7.3f}  {c:6d}  {total/c*1e3:7.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` around the body (CPU activity, and CUDA activity
    where a card is present); on exit the Chrome trace is written to
    ``<logdir>/trace_<time>_<pid>.json``.  Yields ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"))


def device_memory_stats(device: Optional[torch.device] = None) -> Dict[str, float]:
    """GiB in use, peak in use and the card's total; zeros for the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return {"bytes_in_use_gb": 0.0, "peak_bytes_in_use_gb": 0.0, "bytes_limit_gb": 0.0}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use_gb": stats.get("allocated_bytes.all.current", 0) / 1024**3,
        "peak_bytes_in_use_gb": stats.get("allocated_bytes.all.peak", 0) / 1024**3,
        "bytes_limit_gb": torch.cuda.mem_get_info(device)[1] / 1024**3,
    }


def enable_nan_checks(enabled: bool = True) -> None:
    global _NAN_CHECKS
    _NAN_CHECKS = bool(enabled)


def nan_checks_enabled() -> bool:
    return _NAN_CHECKS


def check_finite(stage: str, *tensors: torch.Tensor, step: Optional[int] = None) -> None:
    """With the NaN checks on, raise ``FloatingPointError`` naming ``stage``
    (and ``step``) if any of ``tensors`` holds a NaN or an infinity; a
    no-op otherwise."""
    if not _NAN_CHECKS:
        return
    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            where = stage if step is None else f"{stage} step {step}"
            raise FloatingPointError(f"non-finite values in the output of {where}")
