"""The readers of the denoise stage's split and of its graph's kernel nodes
(``metrics/stage.unet_ms.sweep``, ``stage.controlnet_ms.sweep``,
``graphs.denoise_kernels``) on a run of the tiny sweep on the CPU, in a copy
of the benchmark with the tiny cells added as files: each reads nothing on
the CPU, and with the run's device set to a card each number is the
records' arithmetic.  A CPU edit stamps nothing and captures no graph, so
its stamps are stand-ins (fixed device ns a step, read back as the program
reads them) and its ``graphs.kernels`` records are added over the run.
On a card, the SDXL cell's limit against its control and a half-batch
fault."""

import contextlib
import io
import json
import os
import time

import pytest
import torch

from benchmark import harness
from benchmark.device_trace import Trace
from benchmark.tests import tiny_root
from fastedit_tpu_torch.pipeline.editor import StageTimes
from fastedit_tpu_torch.utils import profiling

METRICS = ("stage.unet_ms.sweep", "stage.controlnet_ms.sweep", "graphs.denoise_kernels")
STEPS = 3  # run steps of the tiny sweep: 4 at strength 0.8
CONTROLNET_NS, UNET_NS = 500_000, 1_800_000  # a step's, in the stand-in stamps


class _Event:
    def __init__(self, ms: float = 0.0):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms


class _Times(StageTimes):
    """Stage times of fixed device ms, in place of CUDA events, and the
    denoise stage's stamps in place of the card's clock."""

    MS = {"encode_prompt": 0.5, "prepare": 0.25, "vae_encode": 1.0, "denoise": 7.0,
          "vae_decode": 2.0}

    @contextlib.contextmanager
    def __call__(self, name):
        yield
        self.events.append((name, _Event(), _Event(self.MS[name])))
        if name == "denoise":
            stamps, t = [], 10 ** 12
            for _ in range(STEPS):
                stamps += [t, t + CONTROLNET_NS, t + CONTROLNET_NS + UNET_NS]
                t += 2 * (CONTROLNET_NS + UNET_NS)
            self.marks = (torch.tensor(stamps), _Event())


@pytest.fixture(scope="module")
def here(tmp_path_factory):
    return tiny_root.make(str(tmp_path_factory.mktemp("split")))


@pytest.fixture(scope="module")
def sweep(here):
    log = io.StringIO()
    run = harness.setup(tiny_root.SWEEP, 2 ** 31 + 17, 3.0, "cpu", here=here, log=log)
    run.profile_seconds = 0.5  # chunks on both sides of the profiled span
    run.editor._stage_times = lambda edit=None: _Times(edit)
    run.trace = Trace(torch.device("cpu"))
    harness.drive(run, run.trace, log=log)
    run.editor = None
    return run


def _read(here, run, name, device):
    run.device = torch.device(device)
    try:
        return harness.reader(name, here)(run)
    finally:
        run.device = torch.device("cpu")


def _outside(run, r):
    """Within the window and clear of the profiled span."""
    t0 = round((run.t_start + run.setup_s) * 1e9)
    t1 = t0 + round(run.window["window_s"] * 1e9)
    p0 = run.trace.t0_ns - profiling.profiler_offset_ns()
    p1 = run.trace.t1_ns - profiling.profiler_offset_ns()
    return t0 <= r.t0_ns and r.t1_ns <= t1 and (r.t1_ns < p0 or r.t0_ns > p1)


def test_the_new_metrics_are_the_sweep_cells(here):
    bench = harness.bench_spec(here)
    rows = {m["name"]: m for m in bench["per_layer"]}
    for name in METRICS:
        assert rows[name]["workloads"][:3] == ["sdxl-bf16.sweep-b4", "ssd1b-bf16.sweep-b4",
                                               "ssd1b-fp32.sweep-b4-g1"]
        assert rows[name]["moves"] == "edits_per_s"
    assert "sdxl-bf16.sweep-b4" in rows["stage.denoise_ms.sweep"]["workloads"]


@pytest.mark.parametrize("name", METRICS)
def test_the_readers_read_nothing_on_the_cpu(here, sweep, name):
    assert _read(here, sweep, name, "cpu") is None


@pytest.mark.parametrize("name,step_ns", [("stage.unet_ms.sweep", UNET_NS),
                                          ("stage.controlnet_ms.sweep", CONTROLNET_NS)])
def test_split_ms_is_each_chunks_stamps_over_its_rows(here, sweep, name, step_ns):
    record = "stage.denoise." + name.split(".")[1].split("_")[0]
    rs = [r for r in profiling.records(record) if _outside(sweep, r)]
    assert rs and {r.ids["rows"] for r in rs} == {sweep.traffic["batch"]}
    assert {r.ids["device_ns"] for r in rs} == {STEPS * step_ns}
    assert _read(here, sweep, name, "cuda") == pytest.approx(
        STEPS * step_ns / 1e6 / sweep.traffic["batch"])


def test_the_split_lies_within_the_denoise_stage(here, sweep):
    split = sum(_read(here, sweep, n, "cuda") for n in METRICS[:2])
    denoise = _read(here, sweep, "stage.denoise_ms.sweep", "cuda")
    assert 0.9 <= split / denoise <= 1.0


def test_denoise_kernels_are_the_cells_keys_last_capture_over_its_steps(here, sweep):
    assert _read(here, sweep, "graphs.denoise_kernels", "cuda") is None  # no graph on the CPU
    b, t = sweep.traffic["batch"], time.perf_counter_ns()
    for stage, batch, cfg, kernels in (("denoise", b, True, 9000), ("denoise", b + 1, True, 1),
                                       ("denoise", b, False, 2), ("vae_decode", b, True, 3),
                                       ("denoise", b, True, 6000)):
        profiling.record("graphs.kernels", t, t, stage=stage, kernels=kernels, batch=batch,
                         cfg=cfg, steps=STEPS)
    profiling.record("graphs.kernels", t, t, stage="encode_prompt", kernels=5, padded=4)
    assert _read(here, sweep, "graphs.denoise_kernels", "cuda") == pytest.approx(6000 / STEPS)


@pytest.mark.cuda
def test_control_fails_the_limit_at_the_sdxl_cells_size():
    """On the card, at the SDXL cell's own sizes: the program reads within
    the configuration's limit, the fp8 control (judged in the program's
    place) beyond it, and so does a half-batch fault."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p = subprocess.run([sys.executable, "benchmark/calibrate.py", "readings", "--workload",
                        "sdxl-bf16.sweep-b4", "--seeds", "97", "--seconds", "3", "--control",
                        "--fault", "rows_mixed"], cwd=root,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    reading = json.loads(p.stdout.strip().splitlines()[-1])
    assert reading["program"]["correct"] is True, reading
    assert reading["control"]["correct"] is False, reading
    assert reading["rows_mixed"]["correct"] is False, reading
