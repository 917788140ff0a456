"""Run one cell of the port's benchmark once, on the card.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout.  Progress and the compared numbers go to
standard error, the numbers last; the last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``, each compared
number with its limit.  Exits non-zero, printing no result, without a card,
with fewer cards than the cell asks for, where the program or the benchmark
fails, or where a JAX module was loaded.  Kernel libraries and caches stay
in fixed directories inside the checkout (``build/``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; no JAX through a library."""
    cache = os.path.join(ROOT, "build", "benchmark_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None, device: str = "cuda") -> int:
    """The run; ``device="cpu"`` is ``rehearse.py``'s, without the look for
    a card."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    _environment()
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT] + [d for d in sys.path if os.path.abspath(d or ".") != here]
    import torch

    from benchmark import harness

    chips = int({w["name"]: w for w in harness.bench_spec()["workloads"]}
                .get(a.workload, {}).get("chips", 1))
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace), device, T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"modules loaded that the run may not load: {found}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
