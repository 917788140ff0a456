"""The port's spans, records and counters (``fastedit_tpu_torch/utils/
profiling.py``) on the CPU: records nest and carry their ids in a bounded
ring; under ``torch.profiler`` every span of an edit lies on the profiler's
timeline at its record's times moved by the offset, and without one no
``record_function`` is entered; the serving records split each request's
time from submit to settle; the graph cache's counters;
``FastEditor.stage_ms()`` reading an edit read back without a wait; a
graph's kernel nodes counted on a stand-in libcuda; and, on the card, the
denoise stage's split kept across a pipelined replay."""

import threading
import time
import types

import numpy as np
import pytest
import torch
import torch.nn as nn
from PIL import Image

from fastedit_tpu_torch import FastEditor
from fastedit_tpu_torch.pipeline import graphs
from fastedit_tpu_torch.pipeline.editor import StageTimes
from fastedit_tpu_torch.serve import EditParams, EditService
from fastedit_tpu_torch.utils import profiling
from test_torch_serve import _StubEditor


@pytest.fixture(scope="module")
def tiny():
    return FastEditor("tiny", device="cpu", use_full_precision=True)


def _img(seed, size=64):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 255, (size, size, 3),
                                                                dtype=np.uint8))


def test_records_nest_and_carry_their_ids():
    t = time.perf_counter_ns()
    before = profiling.totals().get("test.outer", (0, 0.0))[0]
    with profiling.span("test.outer", edit=7) as ids:
        with profiling.span("test.inner", edit=7, rows=2):
            time.sleep(0.002)
        ids["late"] = 3
    profiling.record("test.cross", t, t + 5, request=9)
    profiling.count("test.counter")
    profiling.count("test.counter", 2)
    got = {r.name: r for r in profiling.records(("test.outer", "test.inner", "test.cross"), t)}
    outer, inner = got["test.outer"], got["test.inner"]
    assert outer.t0_ns <= inner.t0_ns < inner.t1_ns <= outer.t1_ns
    assert inner.t1_ns - inner.t0_ns >= 2_000_000
    assert outer.ids == {"edit": 7, "late": 3} and inner.ids == {"edit": 7, "rows": 2}
    assert outer.thread == threading.current_thread().name
    assert got["test.cross"][1:3] == (t, t + 5) and got["test.cross"].ids == {"request": 9}
    assert profiling.records("test.inner", t, inner.t1_ns) == [inner]
    assert profiling.records("test.inner", t, inner.t1_ns - 1) == []
    assert profiling.records("test.inner", inner.t0_ns + 1) == []
    assert profiling.totals()["test.outer"][0] == before + 1
    assert profiling.counters()["test.counter"] >= 3


def test_the_ring_stays_bounded():
    t = time.perf_counter_ns()
    n = profiling.RING_SIZE + 10
    for i in range(n):
        profiling.record("test.ring", t + i, t + i, i=i)
    kept = profiling.records()
    assert len(kept) == profiling.RING_SIZE
    ring = [r.ids["i"] for r in kept if r.name == "test.ring"]
    assert ring == list(range(10, n))  # the oldest dropped first
    assert profiling.totals()["test.ring"][0] == n  # totals outlive the ring


def test_every_span_lies_on_the_profilers_timeline(tiny):
    """A tiny edit under a CPU ``torch.profiler``: every span the edit made
    on this thread is among the profiler's events, and its record, moved by
    the offset, starts and ends within 1 ms of the profiler's event."""
    t = time.perf_counter_ns()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tiny.edit_batch([_img(1), _img(2)], ["a tracing prompt", "another one"], seed=3)
    mine = [r for r in profiling.records(since_ns=t)
            if r.thread == threading.current_thread().name and r.t1_ns > r.t0_ns]
    names = {r.name for r in mine}
    assert {"facade.encode_prompts", "facade.tokenize", "facade.inputs",
            "facade.readback_enqueue", "facade.readback", "facade.to_pil"} <= names
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            events.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    off = profiling.profiler_offset_ns()
    for name in names:
        recs = sorted((r.t0_ns + off, r.t1_ns + off) for r in mine if r.name == name)
        assert len(events.get(name, [])) == len(recs), name
        for (a, b), (c, d) in zip(recs, sorted(events[name]), strict=True):
            assert abs(a - c) < 1_000_000 and abs(b - d) < 1_000_000, (name, a - c, b - d)


def test_no_record_function_without_a_profiler(tiny, monkeypatch):
    entered = []

    def record_function(name):
        entered.append(name)
        return torch.profiler.record_function(name)

    monkeypatch.setattr(profiling, "_record_function", record_function)
    tiny.edit(_img(4), "no profiler here", seed=1)
    with profiling.span("test.quiet"):
        pass
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("test.loud"):
            pass
    assert entered == ["test.loud"]


def test_serve_records_split_each_request_from_submit_to_settle():
    """Twelve requests in bursts over the stub editor (a dispatch takes 10
    ms): one ``serve.queue_wait`` per request, with its id; the request's
    wait and the parts of its batch's coalescing window, dispatch, readback
    and delivery that it lived through add up to its submit-to-settle time
    within 1 ms; and ``stats()`` summarises them."""
    stub = _StubEditor()
    t = time.perf_counter_ns()
    settled, futs = {}, []
    with EditService(stub, max_batch=4, batch_window_ms=20) as svc:
        for k in range(12):
            if k % 5 == 4:
                time.sleep(0.03)
            futs.append(svc.submit(_img(k, 8), f"p {k}", EditParams(seed=k % 2)))
            futs[-1].add_done_callback(
                lambda f, k=k: settled.__setitem__(k, time.perf_counter_ns()))
        for f in futs:
            f.result(timeout=30)
        stats = svc.stats()
        sid = svc._id
    recs = [r for r in profiling.records(since_ns=t) if r.ids.get("service") == sid]
    waits = sorted((r for r in recs if r.name == "serve.queue_wait"),
                   key=lambda r: r.ids["request"])
    assert len(waits) == 12 and len({r.ids["request"] for r in waits}) == 12
    by_batch = {}
    for r in recs:
        if r.name in ("serve.coalesce", "serve.dispatch", "serve.readback", "serve.deliver"):
            by_batch.setdefault(r.ids["batch"], []).append(r)
    for k, w in enumerate(waits):  # one submitting thread: ids in submit order
        parts = sorted(by_batch[w.ids["batch"]], key=lambda r: r.t0_ns)
        assert [r.name for r in parts] == ["serve.coalesce", "serve.dispatch",
                                           "serve.readback", "serve.deliver"]
        lived = sum(max(0, min(r.t1_ns, settled[k]) - max(r.t0_ns, w.t1_ns)) for r in parts)
        assert abs(w.t1_ns - w.t0_ns + lived - (settled[k] - w.t0_ns)) < 1_000_000, k
    assert stats["queue_wait_ms"]["count"] == stats["latency_ms"]["count"] == 12
    assert stats["dispatch_ms"]["count"] == stats["readback_ms"]["count"] == stats["batches"]
    assert stats["dispatch_ms"]["p50"] >= 10.0
    assert stats["latency_ms"]["p95"] >= stats["latency_ms"]["p50"] >= stats["queue_wait_ms"]["p50"]


class _Inputs:
    def copy_(self, other):
        pass


def test_graph_counters_count_captures_and_evictions(monkeypatch):
    """The cache driven as ``test_torch_bench`` drives it: 70 keys (6
    evicted past the cap), a replay, then a weight written in place (the 64
    kept dropped) and one capture more."""
    layer = nn.Linear(2, 2)
    eg = graphs.EditGraphs(types.SimpleNamespace(unet=layer, controlnet=nn.Module(),
                                                 vae=nn.Module()))
    made = []
    monkeypatch.setattr(eg, "_capture", lambda inp: made.append(inp) or graphs.Captured(
        _Inputs(), {}, latents=None, out=len(made), pool_bytes=0))
    before = profiling.counters()
    t = time.perf_counter_ns()
    for i in range(70):
        eg.run(("key", i), None)
    eg.run(("key", 69), None)
    with torch.no_grad():
        layer.weight.add_(1.0)
    eg.run(("key", 69), None)
    after = profiling.counters()
    assert after["graphs.captures"] - before.get("graphs.captures", 0) == 71
    assert after["graphs.evictions"] - before.get("graphs.evictions", 0) == 6 + 64
    assert len(profiling.records("graphs.capture", t)) == 71
    assert len(profiling.records("graphs.copy_inputs", t)) == 72


class _Event:
    """A CUDA event's stand-in: 2.5 ms after its start; ``synchronize``
    raises unless allowed."""

    def __init__(self, waits=None):
        self.waits = waits

    def synchronize(self):
        if self.waits is None:
            raise AssertionError("waited on an edit already read back")
        self.waits.append(self)

    def elapsed_time(self, end):
        return 2.5


def test_stage_ms_makes_no_wait_once_the_edit_was_read_back(tiny):
    times = StageTimes(edit=41)
    times.rows = 1
    times.events.append(("denoise", _Event(), _Event()))
    t = time.perf_counter_ns()
    pending = tiny._pending(torch.zeros(1, 2, 2, 3, dtype=torch.uint8), 0, times)
    assert len(pending.result()) == 1  # reads the stages without a wait
    assert tiny.stage_ms() == {"denoise": 2.5} and pending.stage_ms() == {"denoise": 2.5}
    (rec,) = profiling.records("stage.denoise", t)
    assert rec.ids == {"edit": 41, "rows": 1, "device_ns": 2_500_000}
    # not read back yet: stage_ms() waits for the stage's end event, once
    waits = []
    times = StageTimes(edit=42)
    times.events.append(("denoise", _Event(waits), _Event(waits)))
    tiny._pending(torch.zeros(1, 2, 2, 3, dtype=torch.uint8), 0, times)
    assert tiny.stage_ms() == {"denoise": 2.5} and len(waits) == 1
    assert tiny.stage_ms() == {"denoise": 2.5} and len(waits) == 1


class _LibCuda:
    """The calls of libcuda that count a graph's kernels, over a table of
    graphs (handle -> [(node type, child graph handle or None)]) and of
    streams (handle -> (capture status, the graph it captures into))."""

    def __init__(self, graphs, streams=None):
        self.graphs, self.nodes, self.streams = graphs, {}, streams or {}

    def cuStreamGetCaptureInfo_v2(self, stream, status, id_out, graph, deps, n_deps):
        status._obj.value, graph._obj.value = self.streams[stream]
        return 0

    def cuGraphGetNodes(self, graph, nodes, n):
        items = self.graphs[graph]
        if nodes is not None:
            for i, item in enumerate(items):
                nodes[i] = 1000 * graph + i + 1
                self.nodes[nodes[i]] = item
        n._obj.value = len(items)
        return 0

    def cuGraphNodeGetType(self, node, kind):
        kind._obj.value = self.nodes[node][0]
        return 0

    def cuGraphChildGraphNodeGetGraph(self, node, child):
        child._obj.value = self.nodes[node][1]
        return 0


def test_kernel_nodes_count_kernels_and_child_graphs_kernels():
    """A graph of 3 kernels, a memset, an event record and a child graph of 2
    kernels and a memcpy: 5 kernel nodes; an empty graph has none."""
    kernel, memcpy, memset, child, record = 0, 1, 2, 4, 7
    lib = _LibCuda({1: [(kernel, None), (memset, None), (kernel, None), (child, 2),
                       (record, None), (kernel, None)],
                   2: [(kernel, None), (memcpy, None), (kernel, None)], 3: []})
    assert graphs.kernel_nodes(1, lib) == 5
    assert graphs.kernel_nodes(2, lib) == 2
    assert graphs.kernel_nodes(3, lib) == 0


def test_the_capturing_graph_is_the_streams_capture_in_progress():
    lib = _LibCuda({}, {0x10: (1, 7), 0x20: (0, None)})
    assert graphs.capturing_graph(0x10, lib) == 7
    with pytest.raises(RuntimeError, match="no capture"):
        graphs.capturing_graph(0x20, lib)


@pytest.mark.cuda
def test_the_denoise_split_survives_a_pipelined_replay():
    """On the card, two chunks of one key, the second dispatched before the
    first is read back: each chunk's ``stage.denoise.controlnet`` and
    ``stage.denoise.unet`` records sum to 90-100% of its ``stage.denoise``
    record (the rest: the conditioning tower, CFG and the LCM steps), and the
    first chunk's stamps, read after the second launched, all precede the
    second's: the copy behind each replay kept its own chunk's.  The capture
    records its graphs' kernel nodes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    editor = FastEditor("ssd-1b", random_weights=True)
    imgs = np.random.default_rng(5).integers(0, 255, (2, 1024, 1024, 3), dtype=np.uint8)
    t = time.perf_counter_ns()
    editor.edit_batch(imgs, ["a first prompt", "a second one"], seed=1)  # captured
    kernels = {r.ids["stage"]: r.ids for r in profiling.records("graphs.kernels", t)
               if "batch" in r.ids}
    assert set(kernels) == set(graphs.STAGES)
    assert kernels["denoise"]["batch"] == 2 and kernels["denoise"]["cfg"] is True
    assert kernels["denoise"]["kernels"] > 1000 and kernels["prepare"]["kernels"] >= 1
    t = time.perf_counter_ns()
    first = editor.edit_batch_async(imgs, ["a third prompt", "a fourth"], seed=2)
    second = editor.edit_batch_async(imgs, ["a fifth prompt", "a sixth"], seed=3)
    assert len(first.result()) == 2 and len(second.result()) == 2
    got = {}
    for r in profiling.records(("stage.denoise", "stage.denoise.controlnet",
                                "stage.denoise.unet"), t):
        got.setdefault(r.ids["edit"], {})[r.name] = r.ids["device_ns"]
    for edit in (first.edit, second.edit):
        ns = got[edit]
        share = (ns["stage.denoise.controlnet"] + ns["stage.denoise.unet"]) / ns["stage.denoise"]
        assert 0.9 <= share <= 1.0, (edit, ns)
    a = first._parts[0].times.marks[0].tolist()
    b = second._parts[0].times.marks[0].tolist()
    assert a == sorted(a) and b == sorted(b) and a[-1] < b[0], (a, b)
