"""Build variants of one kernel library and check and time them in turns on one card.

    python fastedit_tpu_torch/tools/kernel_variants.py SPEC.py

How to find what limits a kernel where no profiler counter can be read: the
source with one part changed or taken out (a product, the softmax, the loads,
a ring's depth, ``clock64()`` stamps around a loop's phases), every variant
built into ``build/variants/`` (one ``nvcc`` each, all started together),
loaded, and then run in turns within one process, so that all of them see the
same card at the same clocks.  ``PERF.md`` names this script wherever a number
comes from such a run.

``SPEC.py`` is a Python file that defines

* ``LIBRARY``: the kernel library, a key of ``ops/build.KERNELS``;
* ``VARIANTS``: ``{name: [(old text, new text), ...]}``, the replacements made
  in a copy of ``csrc/LIBRARY.cu``, each of which must be found there (an
  empty list is the source as it stands);
* ``run(use)``: the measurement.  ``use(name)`` makes variant ``name`` the
  library that the package's wrappers launch from then on and returns it (a
  ``ctypes.CDLL`` with the signatures of ``ops/build.KERNELS`` set, and any
  further ``extern "C"`` function a variant adds); a variant that did not
  build is missing from ``use.names``.

For every variant it prints nvcc's exit code and what ptxas said of spills and
of lost performance (C7513, C7520: serialised ``wgmma``).  It needs a CUDA card
and ``nvcc``; a variant that hangs the card never returns, so try a new barrier
scheme in a subprocess with a timeout.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def apply(text: str, replacements) -> str:
    """``text`` with every (old, new) pair replaced; an ``old`` that does not
    occur is an error, so a spec cannot silently fall out of step with the
    source."""
    for old, new in replacements:
        if old not in text:
            raise ValueError(f"not in the source: {old[:80]!r}")
        text = text.replace(old, new)
    return text


def ptxas_notes(log: str) -> list[str]:
    """The lines of an nvcc log (``-Xptxas -v``) that tell of a kernel that
    spills or whose ``wgmma`` ptxas serialised."""
    return [line.strip()[:200] for line in log.splitlines()
            if "Performance Loss" in line or "error" in line.lower()
            or ("spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line)]


def build_variants(library: str, variants: dict) -> dict:
    """Build every variant of ``csrc/<library>.cu``; returns the loaded
    libraries of those that built, by name."""
    from fastedit_tpu_torch.ops import build

    started = {}
    for name, replacements in variants.items():
        folder = ROOT / "build" / "variants" / f"{library}_{name}"
        if folder.exists():
            shutil.rmtree(folder)
        shutil.copytree(build.CSRC, folder)
        source = folder / f"{library}.cu"
        source.write_text(apply(source.read_text(), replacements))
        target = folder / f"lib{library}.so"
        started[name] = (target, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(target), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (target, proc) in started.items():
        log, _ = proc.communicate()
        print(f"[{name}] nvcc rc {proc.returncode}", *ptxas_notes(log), sep="\n   ", flush=True)
        if proc.returncode != 0:
            print(log[-3000:], flush=True)
            continue
        lib = ctypes.CDLL(str(target))
        for symbol, argtypes in build.KERNELS[library].items():
            fn = getattr(lib, symbol)
            fn.restype, fn.argtypes = ctypes.c_int, argtypes
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    from fastedit_tpu_torch.ops import build

    spec: dict = {}
    exec(compile(Path(argv[0]).read_text(), argv[0], "exec"), spec)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0], flush=True)
    library = spec["LIBRARY"]
    libs = build_variants(library, spec["VARIANTS"])

    def use(name: str):
        build._libs[library] = libs[name]
        return libs[name]

    use.names = list(libs)
    spec["run"](use)
    return 0


if __name__ == "__main__":
    sys.exit(main())
