"""The readers of the program's spans and records (``metrics/stage.*``,
``graphs.*``, ``facade.*`` and ``serve.*_ms.serve``) on runs of the tiny
cells on the CPU, in a copy of the benchmark with tiny cells added as
files: each reads nothing on the CPU, and with the run's device set to a
card each number is the records' arithmetic.  A CPU edit has no CUDA events
and no graphs, so its stage times come from stand-in events (fixed ms a
stage) and the graph spans are records added over the run's own edits."""

import contextlib
import io
import time

import pytest
import torch

from benchmark import harness
from benchmark.device_trace import Trace
from benchmark.tests import tiny_root
from fastedit_tpu_torch.pipeline.editor import StageTimes
from fastedit_tpu_torch.utils import profiling

SWEEP_METRICS = ("stage.denoise_ms.sweep", "graphs.replay_ms.sweep", "facade.prompt_ms.sweep",
                 "facade.readback_ms.sweep")
SERVE_METRICS = ("serve.queue_wait_ms.serve", "serve.dispatch_ms.serve")
SETUP_METRICS = ("graphs.capture_s", "facade.build_s")


class _Event:
    def __init__(self, ms: float = 0.0):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms


class _Times(StageTimes):
    """Stage times of fixed device ms, in place of CUDA events."""

    MS = {"encode_prompt": 0.5, "prepare": 0.25, "vae_encode": 1.0, "denoise": 7.0,
          "vae_decode": 2.0}

    @contextlib.contextmanager
    def __call__(self, name):
        yield
        self.events.append((name, _Event(), _Event(self.MS[name])))


def _run(here, workload, trace: bool):
    log = io.StringIO()
    run = harness.setup(workload, 2 ** 31 + 11, 3.0, "cpu", here=here, log=log)
    run.profile_seconds = 0.5  # chunks on both sides of the profiled span
    run.editor._stage_times = lambda edit=None: _Times(edit)
    tr = Trace(torch.device("cpu")) if trace else None
    harness.drive(run, tr, log=log)
    run.trace, run.editor = tr, None
    return run


@pytest.fixture(scope="module")
def here(tmp_path_factory):
    return tiny_root.make(str(tmp_path_factory.mktemp("spans")))


@pytest.fixture(scope="module")
def sweep(here):
    return _run(here, tiny_root.SWEEP, trace=True)


@pytest.fixture(scope="module")
def serve(here):
    return _run(here, tiny_root.SERVE, trace=False)


def _read(here, run, name, device):
    run.device = torch.device(device)
    try:
        return harness.reader(name, here)(run)
    finally:
        run.device = torch.device("cpu")


def _window(run):
    t0 = round((run.t_start + run.setup_s) * 1e9)
    return t0, t0 + round(run.window["window_s"] * 1e9)


def _outside(run, r):
    """Within the window and clear of the profiled span."""
    t0, t1 = _window(run)
    p0 = run.trace.t0_ns - profiling.profiler_offset_ns()
    p1 = run.trace.t1_ns - profiling.profiler_offset_ns()
    return t0 <= r.t0_ns and r.t1_ns <= t1 and (r.t1_ns < p0 or r.t0_ns > p1)


@pytest.mark.parametrize("name", SWEEP_METRICS + SETUP_METRICS)
def test_sweep_readers_read_nothing_on_the_cpu(here, sweep, name):
    assert _read(here, sweep, name, "cpu") is None


@pytest.mark.parametrize("name", SERVE_METRICS)
def test_serve_readers_read_nothing_on_the_cpu(here, serve, name):
    assert _read(here, serve, name, "cpu") is None


def test_the_profiled_span_leaves_chunks_on_both_sides(sweep):
    p0 = sweep.trace.t0_ns - profiling.profiler_offset_ns()
    inputs = profiling.records("facade.inputs", *_window(sweep))
    assert any(r.t1_ns < p0 for r in inputs) and any(r.t0_ns > p0 for r in inputs)
    assert any(not _outside(sweep, r) for r in inputs)


def test_denoise_ms_is_each_chunks_device_ms_over_its_rows(here, sweep):
    got = _read(here, sweep, "stage.denoise_ms.sweep", "cuda")
    rs = [r for r in profiling.records("stage.denoise") if _outside(sweep, r)]
    assert rs and {r.ids["rows"] for r in rs} == {sweep.traffic["batch"]}
    assert got == pytest.approx(_Times.MS["denoise"] / sweep.traffic["batch"])


def test_prompt_ms_is_encoding_seconds_over_new_prompts(here, sweep):
    rs = [r for r in profiling.records("facade.encode_prompts") if _outside(sweep, r)]
    want = sum(r.t1_ns - r.t0_ns for r in rs) / 1e6 / sum(r.ids["new_prompts"] for r in rs)
    assert _read(here, sweep, "facade.prompt_ms.sweep", "cuda") == pytest.approx(want)


def test_readback_ms_is_to_pil_per_chunk(here, sweep):
    rs = [r for r in profiling.records("facade.to_pil") if _outside(sweep, r)]
    edits = {r.ids["edit"] for r in rs}
    want = sum(r.t1_ns - r.t0_ns for r in rs) / 1e6 / len(edits)
    assert _read(here, sweep, "facade.readback_ms.sweep", "cuda") == pytest.approx(want)


def test_replay_ms_sums_each_whole_chunks_graph_records(here, sweep):
    """Graph records added inside each chunk's ``facade.inputs`` span: the
    chunks clear of the profiled span count, and a chunk one of whose
    records lies before the window does not."""
    inputs = profiling.records("facade.inputs")
    first = min((r for r in inputs if _outside(sweep, r)), key=lambda r: r.t0_ns)
    spans = []
    for r in inputs:
        a, b = r.t0_ns, r.t1_ns
        profiling.record("graphs.copy_inputs", a, a + (b - a) // 4, edit=r.ids["edit"])
        profiling.record("graphs.replay", a + (b - a) // 2, b, stage="denoise", edit=r.ids["edit"])
        spans.append((r, (b - a) // 4 + (b - a) - (b - a) // 2))
    profiling.record("graphs.replay", 0, 1, stage="prepare", edit=first.ids["edit"])
    want = [ns for r, ns in spans if _outside(sweep, r) and r is not first]
    assert want
    assert _read(here, sweep, "graphs.replay_ms.sweep", "cuda") == pytest.approx(
        sum(want) / len(want) / 1e6)


def test_setup_seconds_are_the_set_ups_records(here, sweep):
    s0 = round(sweep.t_start * 1e9)
    opened = s0 + round(sweep.setup_s * 1e9)
    (build,) = profiling.records("facade.build", s0, opened)
    assert _read(here, sweep, "facade.build_s", "cuda") == pytest.approx(
        (build.t1_ns - build.t0_ns) / 1e9)
    assert _read(here, sweep, "graphs.capture_s", "cuda") is None  # no graph on the CPU
    profiling.record("graphs.capture", s0 + 10, s0 + 2_000_010, prompt=0, edit=None)
    profiling.record("graphs.capture", opened + 1, opened + 5_000_001, prompt=0, edit=None)
    assert _read(here, sweep, "graphs.capture_s", "cuda") == pytest.approx(0.002)


def test_serve_readers_take_the_windows_requests_and_their_batches(here, serve):
    t0, _ = _window(serve)
    n = serve.window["attempted"]
    waits = [r for r in profiling.records("serve.queue_wait") if r.t0_ns >= t0]
    first = min(r.ids["request"] for r in waits)
    mine = [r for r in waits if first <= r.ids["request"] < first + n]
    assert len(mine) == n
    # a request after the window's, as the traced run's sentinel is, with its batch
    late = time.perf_counter_ns()
    profiling.record("serve.queue_wait", late, late + 10 ** 10, request=first + 10 ** 6,
                     batch=-1, service=0)
    profiling.record("serve.dispatch", late, late + 6 * 10 ** 9, batch=-1, service=0)
    assert _read(here, serve, "serve.queue_wait_ms.serve", "cuda") == pytest.approx(
        sum(r.t1_ns - r.t0_ns for r in mine) / n / 1e6)
    batches = {r.ids["batch"] for r in mine}
    ds = [r.t1_ns - r.t0_ns for r in profiling.records("serve.dispatch")
          if r.ids["batch"] in batches]
    assert len(ds) == len(batches)
    assert _read(here, serve, "serve.dispatch_ms.serve", "cuda") == pytest.approx(
        sum(ds) / len(ds) / 1e6)
