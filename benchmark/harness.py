"""One run of one cell: set-up, the measured window, the check of what the
window produced, and the result line.

Everything that belongs to one cell is found by name: ``BENCHMARK.json``
(beside this folder) names the cell's configuration and traffic; the
configuration's file is the one the cell's configuration entry names, the
traffic's ``traffic/<traffic>.json``, and each metric is read by
``metrics/<metric>.py`` (a function ``read(run)`` returning a number, or
None where the run has nothing to read it from).  The traffic file's
``kind`` picks the driver (``drivers.KINDS``).

Set-up, timed from the process's start: the program's imports, its kernel
libraries built or loaded (``build/kernels/`` in the checkout), the editor,
the benchmark's seeded weights written into it, the driver's warm-up of the
cell's shapes.  Then the window.  After it: the peak device memory, the
profiled events read (a traced run), the arrivals' lateness checked (a run
whose traffic fell behind its schedule fails), the check that no JAX module
was loaded, the program's state freed, and the plain reference
(``reference/``) run over a sample of the window's answers drawn from the
seed; ``correct`` is each compared number within its limit.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "fastedit_tpu")
PROFILE_SECONDS = 3.0
# The latest an arrival may be sent after it was due: serving runs on an H100
# send within 7-44 ms (PERF.md), the time to make the next scene and the
# service's threads holding the interpreter.
LATE_LIMIT_S = 0.1


class HarnessError(RuntimeError):
    pass


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def bench_spec(here: str = HERE) -> dict:
    return load_json(os.path.join(os.path.dirname(here), "BENCHMARK.json"))


def cell_files(bench: dict, workload: str, here: str = HERE):
    """(cell, configuration dict, traffic dict) of ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise HarnessError(f"no workload {workload!r}; the cells are {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    root = os.path.dirname(here)
    cfg = load_json(os.path.join(root, entry["file"]))
    traffic = load_json(os.path.join(here, "traffic", cell["traffic"] + ".json"))
    return cell, cfg, traffic


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` reports: end to end with
    ``trace`` off, per layer with it on."""
    rows = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in rows if workload in m.get("workloads", [workload])]


def reader(name: str, here: str = HERE):
    path = os.path.join(here, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """What a run knows; the metric readers take it."""

    def __init__(self, cell, cfg, traffic, seed, seconds, device, t_start, here=HERE):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.seed, self.seconds = int(seed), float(seconds)
        self.device, self.t_start = device, t_start
        self.profile_seconds = PROFILE_SECONDS
        self.peaks = load_json(os.path.join(here, "peaks.json"))
        self.editor = self.scenes = None
        self.setup_s = None
        self.window: dict = {}
        self.trace = None
        self.peak_bytes = 0

    def synchronize(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark_open(self, t: float) -> None:
        self.setup_s = t - self.t_start

    @property
    def peak_flops(self) -> float:
        return self.peaks["flops_per_s"][self.cfg["peak"]]


def _phase(log, what: str, t_start: float) -> None:
    print(f"set-up: {what} at {time.perf_counter() - t_start:.3f} s", file=log, flush=True)


def _build_editor(run, log=sys.stderr):
    import torch

    from fastedit_tpu_torch.pipeline.editor import FastEditor

    from benchmark import weights

    kw = dict(run.cfg["program"])
    name = kw.pop("model_name")
    if run.device.type == "cuda":
        from fastedit_tpu_torch.ops import build

        build.build_all()
        _phase(log, "kernel libraries ready", run.t_start)
    editor = FastEditor(name, device=str(run.device), **kw)
    _phase(log, "editor built", run.t_start)
    if editor.dtype != weights.DTYPES[run.cfg["dtype"]] or editor.resolution != run.cfg[
            "resolution"] or editor._control_res != run.cfg["control_resolution"]:
        raise HarnessError("the program's editor is not the configuration's: dtype "
                           f"{editor.dtype}, resolution {editor.resolution}, control "
                           f"{editor._control_res}")
    weights.fill_program(editor, run.cfg, run.seed)
    editor.clear_memory()
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    _phase(log, "weights written", run.t_start)
    return editor


def graph_keys(editor) -> set:
    """The keys of the CUDA graphs the editor holds (none on the CPU)."""
    g = getattr(editor, "_graphs", None)
    return set(g.captured) if g is not None else set()


def judge(run, samples: list, control: str | None = None) -> dict:
    """The plain reference over the sampled answers; the compared numbers
    with their limits.  With ``control`` (a mode of ``reference/numerics.py``)
    the answers judged are the reference's own in that precision, put in the
    program's place: the control that has to come out as not correct."""
    import torch

    from benchmark import weights
    from benchmark.reference.pipeline import Reference, to_uint8

    ref = Reference(run.cfg, weights.draw(run.cfg, run.seed, run.device), run.device)
    low = None if control is None else Reference(
        run.cfg, weights.draw(run.cfg, run.seed, run.device), run.device, mode=control)
    guidance = float(run.traffic["guidance_scale"])
    per_image = []  # mean |difference| in LSB of each image, judged one by one
    for imgs, prompts, seed, got in samples:
        x = torch.from_numpy(imgs)
        want = to_uint8(ref.edit(x, prompts, guidance, seed, tile_noise=True)).cpu().numpy()
        if low is not None:
            got = to_uint8(low.edit(x, prompts, guidance, seed, tile_noise=True)).cpu().numpy()
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
        per_image += d.reshape(len(d), -1).mean(axis=1).tolist()
    del ref, low
    return {"worst_lsb": {"value": max(per_image, default=float("inf")),
                          "limit": run.cfg["limits"]["worst_lsb"], "per_image": per_image}}


def verdict(checks: dict) -> bool:
    return all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())


def setup(workload: str, seed: int, seconds: float, device: str = "cuda",
          t_start: float | None = None, here: str = HERE, log=sys.stderr) -> Run:
    """The run up to its editor with the seed's weights in it."""
    import torch

    from benchmark import scenes
    from benchmark.device_trace import families

    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench_spec(here)
    cell, cfg, traffic = cell_files(bench, workload, here)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    run = Run(cell, cfg, traffic, seed, seconds, dev, t_start, here)
    run.bench = bench
    run.families = families()
    run.scenes = scenes.Scenes(run.seed, cfg["resolution"])
    _phase(log, "imported", t_start)
    run.editor = _build_editor(run, log)
    return run


def reseed(run, seed: int) -> None:
    """The same editor with another seed's weights, scenes and prompts."""
    from benchmark import scenes, weights

    run.seed = int(seed)
    run.scenes = scenes.Scenes(run.seed, run.cfg["resolution"])
    weights.fill_program(run.editor, run.cfg, run.seed)
    run.editor.clear_memory()


def drive(run, trace=None, log=sys.stderr) -> list:
    """The driver's warm-up and window, the peak memory, the profiled
    events read, the arrivals' lateness checked; returns the sample of the
    window's answers drawn from the seed."""
    import torch

    from benchmark import drivers

    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    driver = drivers.KINDS[run.traffic["kind"]](run)
    try:
        driver.warm_up()
        if trace is not None:
            trace.prime()
        run.synchronize()
        _phase(log, "warmed up", run.t_start)
        keys = graph_keys(run.editor)
        run.window = driver.window(run.seconds, trace)
        if graph_keys(run.editor) != keys:
            raise HarnessError(f"the window captured CUDA graphs its warm-up did not: "
                               f"{sorted(map(str, graph_keys(run.editor) - keys))}")
        if run.device.type == "cuda":
            run.peak_bytes = int(torch.cuda.max_memory_allocated(run.device))
    finally:
        driver.close()
    if trace is not None:
        trace.collect()
        fam = {k: round(v, 6) for k, v in sorted(trace.family_s(run.families).items())}
        print(f"trace: {len(trace.events)} events, {len(trace.device_events())} on the "
              f"device, busy {trace.busy_s():.6f} s of {trace.span_s:.6f} s, the profiler's "
              f"start {trace.start_s:.6f} s and stop {trace.stop_s:.6f} s; device s by family "
              f"{fam}", file=log)
    if "lateness_s" in run.window:
        late = np.asarray(run.window["lateness_s"])
        late = late[np.isfinite(late)]
        print(f"arrivals: {len(late)} sent, lateness median {np.median(late) * 1e3:.3f} ms, "
              f"max {late.max() * 1e3:.3f} ms, limit {LATE_LIMIT_S * 1e3:.0f} ms", file=log)
        if late.max() > LATE_LIMIT_S:
            raise HarnessError(f"the arrivals fell behind their schedule by up to "
                               f"{late.max() * 1e3:.3f} ms (limit {LATE_LIMIT_S * 1e3:.0f} ms)")
    return driver.sample(np.random.default_rng([run.seed, 4]))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None, here: str = HERE, log=sys.stderr) -> dict:
    """One run of ``workload``; returns the result line's object."""
    import torch

    from benchmark.device_trace import Trace

    run = setup(workload, seed, seconds, device, t_start, here, log)
    dev, bench = run.device, run.bench
    tr = Trace(dev) if trace else None
    samples = drive(run, tr, log)
    run.trace = tr
    run.editor = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    values = {}
    for m in metrics_of(bench, workload, trace):
        v = reader(m["name"], here)(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
        elif not trace and dev.type == "cuda":
            raise HarnessError(f"end-to-end metric {m['name']} read nothing")
    found = forbidden_modules()
    if found:
        raise HarnessError(f"modules loaded that the run may not load: {found}")

    t0 = time.perf_counter()
    checks = judge(run, samples)
    # an answer due in the window that never came, failed or was refused
    checks["missing"] = {"value": int(run.window["failed"]), "limit": 0}
    print(f"reference: {len(checks['worst_lsb'].pop('per_image'))} images in "
          f"{time.perf_counter() - t0:.3f} s", file=log)
    correct = verdict(checks)
    result = {
        "correct": correct,
        "attempted": int(run.window["attempted"]),
        "failed": int(run.window["failed"]),
        "metrics": values,
        "device": device_info(run),
    }
    if tr is not None and tr.events:
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=log)
    return result


def device_info(run) -> dict:
    import torch

    if run.device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
                "count": int(run.cell.get("chips", 1)), "memory_peak_bytes": run.peak_bytes}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s()
        info["window_s"] = run.trace.span_s
    return info
