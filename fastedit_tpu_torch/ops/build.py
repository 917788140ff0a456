"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into ``build/kernels/lib<name>-<hash>.so`` at the repository root, then
loaded with ``ctypes``.  No PyTorch headers are included, so a build takes
seconds.  The hash covers the source, every header of ``csrc/`` it includes
(``#include "..."``, followed through) and the flags, so an edited kernel or
header is rebuilt and a stale library is never loaded.  Nothing is built at import:
the first launch of a kernel builds it, or :func:`build_all` builds every
kernel at once (one ``nvcc`` per source, all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-ldl",
)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The C functions of each library and their argument types; every one
# returns a CUDA error code (int).  Set once, when the library is loaded.
KERNELS = {
    "conv3x3": {
        "conv3x3_smem_bytes": [_I],  # returns bytes, not an error code
        "conv3x3_bf16": [_P] * 4 + [_I] * 8 + [_P],
        "conv3x3_fused_bf16": [_P] * 7 + [_I] * 9 + [_P],
        "conv3x3_up2_smem_bytes": [_I],  # returns bytes
        "conv3x3_up2_bf16": [_P] * 4 + [_I] * 8 + [_P],
        "up2_phase_weights_bf16": [_P] * 2 + [_I] * 2 + [_P],
        "conv3x3_down2_smem_bytes": [_I],  # returns bytes
        "conv3x3_down2_bf16": [_P] * 4 + [_I] * 9 + [_P],
    },
    "flash_attention": {
        "flash_attention_geometry": [_I, _I, _I],  # returns a tile size or bytes
        "flash_attention_bf16": (
            [_P] * 4 + [_I] * 5 + [_L] * 6 + [ctypes.c_float] + [_I] * 3 + [_P]),
    },
    "group_norm": {  # one template over the element type: bf16 and fp32 entries
        "group_norm_slots": [_I, _P],  # cluster, int* out
        **{f"{name}_{dtype}": args
           for dtype in ("bf16", "f32")
           for name, args in (
               ("group_norm_stats", [_P] * 6 + [_I] * 10 + [ctypes.c_float, _P]),
               ("group_norm", [_P] * 6 + [_I] * 10 + [ctypes.c_float, _I, _P]))},
    },
    # the fp32 (quality mode) kernels, on the tensor cores: 3xTF32 wgmma
    "conv3x3_tf32x3": {
        "conv3x3_tf32x3_geometry": [_I, _I, _I],  # returns bytes or a count
        "split_tf32": [_P] * 3 + [_L, _P],
        "conv3x3_tf32x3": [_P] * 5 + [_I] * 8 + [_P],
        "conv3x3_fused_tf32x3": [_P] * 8 + [_I] * 9 + [_P],
        "conv3x3_up2_tf32x3": [_P] * 5 + [_I] * 8 + [_P],
        "conv3x3_down2_tf32x3": [_P] * 5 + [_I] * 9 + [_P],
    },
    # Canny prepare (bf16 and fp32 outputs): one kernel, three entries
    # (ops/canny.py)
    "canny": {
        "canny_slots": [_P],  # int* out
        "canny_smem_bytes": [_I],  # returns bytes
        **{f"{name}_{dtype}": [_P] * ptrs + [_I] * 4 + [_P]
           for dtype in ("bf16", "f32")
           for name, ptrs in (("canny_prepare", 7), ("canny_front", 6),
                              ("canny_hysteresis", 4))},
    },
    "flash_attention_tf32x3": {
        "flash_d64_tf32x3_geometry": [_I],  # returns a tile size, a count or bytes
        "flash_d512_tf32x3_geometry": [_I],
        "flash_attention_d64_tf32x3": (
            [_P] * 5 + [_I] * 4 + [_L] * 6 + [ctypes.c_float, _I, _P]),
        "flash_attention_d512_tf32x3": (
            [_P] * 5 + [_I] * 4 + [_L] * 6 + [ctypes.c_float, _I, _P]),
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built on a machine with "
            "the CUDA toolkit (on PATH or under /usr/local/cuda)"
        )
    return found


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every file of ``csrc/`` it includes with
    ``#include "..."``, directly or through another such file."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        todo += [path.parent / m.decode() for m in _INCLUDE.findall(path.read_bytes())]
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sorted(sources(name)):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one kernel; returns (target, process) or (target, None)
    when the library is already built."""
    target = _target(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return target, (proc, tmp)


def _finish(name: str, target: Path, started) -> str:
    """Wait for nvcc; returns its log, kept beside the library."""
    log_path = target.with_suffix(".log")
    if started is None:
        return log_path.read_text() if log_path.exists() else ""
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    log_path.write_text(log)
    os.replace(tmp, target)
    return log


def build_all() -> dict[str, str]:
    """Build every kernel in parallel; returns nvcc's log (``-Xptxas -v``:
    registers, shared memory and spills per kernel) by kernel name, also
    for a library built earlier."""
    started = {name: _start(name) for name in KERNELS}
    logs = {}
    errors = []
    for name, (target, st) in started.items():
        try:
            logs[name] = _finish(name, target, st)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def library_path(name: str) -> Path:
    """Where kernel library ``name`` is (or will be) built."""
    return _target(name)


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed, with the
    signatures of its C functions set."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            target, st = _start(name)
            _finish(name, target, st)
            lib = ctypes.CDLL(str(target))
            for symbol, argtypes in KERNELS[name].items():
                fn = getattr(lib, symbol)
                fn.restype, fn.argtypes = ctypes.c_int, argtypes
            _libs[name] = lib
        return _libs[name]
