"""A copy of the benchmark with tiny cells added as files, for the CPU tests.

:func:`make` copies ``BENCHMARK.json`` and ``benchmark/`` into a directory,
adds the tiny configuration and traffic fixtures as files of their own, and
adds their cells and configuration to the copy's ``BENCHMARK.json`` (each
metric that names its cells gets the tiny cell of its kind).  No existing
file of the copy is changed but ``BENCHMARK.json``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FIXTURES = os.path.join(BENCH, "tests", "fixtures")
SWEEP, SERVE = "tiny-fp32.sweep-tiny", "tiny-fp32.serve-tiny"


def make(dest: str) -> str:
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(BENCH, os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(FIXTURES, "tiny-fp32.json"),
                os.path.join(dest, "benchmark", "configs", "tiny-fp32.json"))
    for t in ("sweep-tiny", "serve-tiny"):
        shutil.copy(os.path.join(FIXTURES, t + ".json"),
                    os.path.join(dest, "benchmark", "traffic", t + ".json"))
    path = os.path.join(dest, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    b["configs"].append({"name": "tiny-fp32", "source": b["configs"][0]["source"],
                         "file": "benchmark/configs/tiny-fp32.json", "reduced": [],
                         "why": "the port's tiny smoke model, for the CPU tests"})
    b["workloads"] += [
        {"name": SWEEP, "config": "tiny-fp32", "traffic": "sweep-tiny", "chips": 1, "why": "t"},
        {"name": SERVE, "config": "tiny-fp32", "traffic": "serve-tiny", "chips": 1, "why": "t"},
    ]
    for m in b["end_to_end"] + b["per_layer"]:
        cells = m.get("workloads")
        if cells is not None:
            cells.append(SWEEP if any(".sweep" in c for c in cells) else SERVE)
    with open(path, "w") as f:
        json.dump(b, f, indent=1)
    return os.path.join(dest, "benchmark")


def rehearse(root: str, workload: str, seed: int, seconds: float, trace: int = 0):
    """``benchmark/rehearse.py`` of the copy at ``root`` in a process of its
    own; returns (exit code, stdout, stderr)."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "benchmark/rehearse.py", "--workload", workload,
                        "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                       cwd=root, env=env, capture_output=True, text=True, timeout=600)
    return p.returncode, p.stdout, p.stderr
