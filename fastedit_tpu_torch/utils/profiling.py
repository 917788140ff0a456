"""Tracing, stage timing, memory and NaN checks (the counterpart of the JAX
package's ``utils/profiling.py``), and the program's own spans and counters.

* :class:`span` times a named stretch of host work on one thread and keeps
  a record of it; :func:`record` keeps the record of an interval that
  starts on one thread and ends on another (a request's wait in a queue);
  :func:`count` adds to a counter.  Every record is ``(name, t0_ns, t1_ns,
  thread, ids)`` on ``time.perf_counter_ns``, the clock of the benchmark's
  own marks, with small ids (``edit``, ``request``, ``batch``, ``rows``,
  ...); the last :data:`RING_SIZE` are kept, and each name's count and
  total for the life of the process.  Readers: :func:`records`,
  :func:`totals`, :func:`counters`.  While ``torch.profiler`` records the
  calling thread, a span also opens a ``record_function`` of its name, so
  it lies on the device trace's timeline; :func:`profiler_offset_ns` moves
  a record onto the profiler's clock.  With no profiler running, that part
  costs one flag test.
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

import collections
import contextlib
import os
import threading
import time
from typing import Dict, Optional

import torch

_NAN_CHECKS = False

# ------------------------------------------------------------------ spans

RING_SIZE = 1 << 16  # records kept, the oldest dropped first

Record = collections.namedtuple("Record", "name t0_ns t1_ns thread ids")

_ring: collections.deque = collections.deque(maxlen=RING_SIZE)
_totals: Dict[str, list] = {}  # name -> [count, total ns]
_counters: Dict[str, int] = {}
_lock = threading.Lock()
# whether torch.profiler records the calling thread (its callbacks are the thread's own)
_profiling = torch._C._autograd._profiler_enabled
_record_function = torch.profiler.record_function


def _measure_offset() -> int:
    """``time.time_ns() - time.perf_counter_ns()`` from the closest of a
    few adjacent readings."""
    best = None
    for _ in range(8):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


_OFFSET_NS = _measure_offset()


def profiler_offset_ns() -> int:
    """What to add to a record's times to put them on the profiler's clock
    (its events' ``start_ns()``, Unix time in ns), measured once."""
    return _OFFSET_NS


def _add(name: str, t0: int, t1: int, ids: dict) -> None:
    rec = (name, t0, t1, threading.current_thread().name, ids)
    with _lock:
        _ring.append(rec)
        total = _totals.get(name)
        if total is None:
            _totals[name] = [1, t1 - t0]
        else:
            total[0] += 1
            total[1] += t1 - t0


class span:
    """``with span("layer.what", edit=3, rows=4) as ids:`` times the body
    on ``perf_counter_ns`` and keeps its record; ``ids`` (the keyword
    dict) may gain entries inside the body, such as an id known only once
    a call returns.  Under a running ``torch.profiler`` the body is also a
    ``record_function`` of the same name."""

    __slots__ = ("name", "ids", "_t0", "_fn")

    def __init__(self, name: str, **ids):
        self.name, self.ids = name, ids

    def __enter__(self) -> dict:
        self._t0 = time.perf_counter_ns()
        self._fn = None
        if _profiling():  # the record encloses the profiler's event
            self._fn = _record_function(self.name)
            self._fn.__enter__()
        return self.ids

    def __exit__(self, *exc) -> bool:
        if self._fn is not None:
            self._fn.__exit__(*exc)
        _add(self.name, self._t0, time.perf_counter_ns(), self.ids)
        return False


def record(name: str, t0_ns: int, t1_ns: int, **ids) -> None:
    """Keep the record of an interval timed elsewhere on
    ``perf_counter_ns``; it does not appear on the profiler's timeline."""
    _add(name, t0_ns, t1_ns, ids)


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def records(name=None, since_ns: Optional[int] = None, until_ns: Optional[int] = None) -> list:
    """The kept :class:`Record` s, oldest first: of ``name`` (a name or a
    tuple of names; all without), lying within ``[since_ns, until_ns]``."""
    with _lock:
        kept = list(_ring)
    names = (name,) if isinstance(name, str) else name
    return [Record(*r) for r in kept
            if (names is None or r[0] in names) and (since_ns is None or r[1] >= since_ns)
            and (until_ns is None or r[2] <= until_ns)]


def totals() -> Dict[str, tuple]:
    """``{name: (count, seconds)}`` of every span and record since the
    process started."""
    with _lock:
        return {k: (n, ns / 1e9) for k, (n, ns) in _totals.items()}


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


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
