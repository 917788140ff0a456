"""Runs of the harness on the CPU at the tiny size, in copies of the
benchmark with tiny cells added as files: what a run imports, a cell, a
configuration, a traffic mix and a metric added without editing a file,
``correct`` under planted faults, and the entry's refusal without a card."""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import drivers, faults, harness
from benchmark.tests import tiny_root

PARAMS = ["--workload", "ssd1b-bf16.sweep-b4", "--seed", "1", "--seconds", "1"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    d = tmp_path_factory.mktemp("bench")
    tiny_root.make(str(d))
    return str(d)


def _result(rc, out, err):
    assert rc == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def test_sweep_runs_and_imports_no_jax(root):
    """A whole run in a process of its own: correct, its metrics read, and
    (rehearse.py exits 3 otherwise) no JAX module loaded."""
    res = _result(*tiny_root.rehearse(root, tiny_root.SWEEP, 2 ** 31 + 5, 2))
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"setup_s", "edits_per_s"}  # the CPU states no memory
    assert list(res)[-1] == "checks"
    assert res["checks"]["worst_lsb"]["value"] <= res["checks"]["worst_lsb"]["limit"]


def test_serve_runs_traced(root):
    res = _result(*tiny_root.rehearse(root, tiny_root.SERVE, 7, 2, trace=1))
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"serve.batch_mean.serve"}
    assert res["device"]["platform"] == "cpu" and res["device"]["busy_s"] == 0.0


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.pipeline, benchmark.weights, "
            "benchmark.scenes, benchmark.work; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('fastedit_tpu_torch', 'fastedit_tpu', 'jax', 'jaxlib', 'flax')); "
            "print(bad); sys.exit(1 if bad else 0)")
    p = subprocess.run([sys.executable, "-c", code], cwd=tiny_root.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr


def test_run_refuses_without_a_card():
    p = subprocess.run([sys.executable, "benchmark/run.py", *PARAMS], cwd=tiny_root.ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    """A checkout with only BENCHMARK.json and the benchmark's files."""
    tiny_root.make(str(tmp_path))
    p = subprocess.run([sys.executable, "benchmark/run.py", *PARAMS], cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=300,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode != 0 and p.stdout.strip() == ""


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            if "__pycache__" not in path:
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


NEW_METRIC = '''"""Chunks the profiled sub-window ran (a metric added as a file)."""


def read(run):
    p = run.window.get("profiled") or {}
    return p.get("chunks")
'''


def test_new_cell_config_traffic_and_metric_are_files(tmp_path):
    """One more configuration, traffic mix, cell and per-layer metric, each
    a file of its own and an entry: listed and run, no existing file edited."""
    root = str(tmp_path)
    tiny_root.make(root)
    before = _digests(root)
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "tiny-fp32.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny-fp32-b"
    with open(os.path.join(bench, "configs", "tiny-fp32-b.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "sweep-tiny-g1.json"), "w") as f:
        json.dump({"kind": "sweep", "batch": 1, "guidance_scale": 1.0, "checked": 1}, f)
    with open(os.path.join(bench, "metrics", "profiled_chunks.sweep.py"), "w") as f:
        f.write(NEW_METRIC)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    cell = "tiny-fp32-b.sweep-tiny-g1"
    b["configs"].append(dict(b["configs"][-1], name="tiny-fp32-b",
                             file="benchmark/configs/tiny-fp32-b.json"))
    b["workloads"].append({"name": cell, "config": "tiny-fp32-b", "traffic": "sweep-tiny-g1",
                           "chips": 1, "why": "added as files"})
    for m in b["end_to_end"] + b["per_layer"]:
        if m["name"] in ("edits_per_s",):
            m["workloads"].append(cell)
    b["per_layer"].append({"name": "profiled_chunks.sweep", "unit": "chunks",
                           "better": "higher", "source": "host_clock", "layer": "facade",
                           "moves": "edits_per_s", "workloads": [cell]})
    with open(path, "w") as f:
        json.dump(b, f)
    after = _digests(root)
    changed = sorted(k for k in before if before[k] != after.get(k))
    assert changed == ["BENCHMARK.json"]
    assert cell in [w["name"] for w in harness.bench_spec(bench)["workloads"]]
    res = _result(*tiny_root.rehearse(root, cell, 3, 2, trace=1))
    assert res["correct"] is True
    assert res["metrics"]["profiled_chunks.sweep"]["value"] >= 1
    res = _result(*tiny_root.rehearse(root, cell, 3, 1))
    assert set(res["metrics"]) == {"setup_s", "edits_per_s"}


def _faulty(monkeypatch, fault):
    from fastedit_tpu_torch.pipeline import stages

    if fault == "state_unchanged":  # every LCM step returns its input
        monkeypatch.setattr(stages, "lcm_step", lambda sched, i, sample, eps, noise: sample)
    elif fault == "answer_altered":  # the top quarter of each image inverted where made
        decode = stages.vae_decode

        def altered(mod, latents):
            out = decode(mod, latents).clone()
            q = out.shape[1] // 4
            out[:, :q] = 255 - out[:, :q]
            return out

        monkeypatch.setattr(stages, "vae_decode", altered)


@pytest.mark.parametrize("workload", [tiny_root.SWEEP, tiny_root.SERVE])
@pytest.mark.parametrize("fault", [None, "state_unchanged", "answer_altered"])
def test_correct_catches_the_faults(root, monkeypatch, workload, fault):
    """The rest of a run with the timed path broken underneath: ``correct``
    is false under each fault the cells can have, true without one."""
    _faulty(monkeypatch, fault)
    res = harness.run_cell(workload, 2 ** 32 + 3, 1.5, False, "cpu",
                           here=os.path.join(root, "benchmark"))
    check = res["checks"]["worst_lsb"]
    assert res["correct"] is (fault is None), check
    assert np.isfinite(check["value"])


@pytest.mark.parametrize("workload", [tiny_root.SWEEP, tiny_root.SERVE])
def test_control_in_the_programs_place_is_not_correct(root, workload):
    """The same window's sample judged twice by ``harness.judge``: the
    program's answers pass, the control's (the reference one precision
    below the configuration's) fail."""
    run = harness.setup(workload, 2 ** 31 + 9, 1.5, "cpu", here=os.path.join(root, "benchmark"))
    samples = harness.drive(run)
    assert harness.verdict(harness.judge(run, samples))
    control = harness.judge(run, samples, control=run.cfg["control"])
    assert not harness.verdict(control), control


def test_rows_mixed_is_not_correct(root):
    """Half of each chunk's rows computed with another row's prompt."""
    run = harness.setup(tiny_root.SWEEP, 2 ** 31 + 13, 1.5, "cpu",
                        here=os.path.join(root, "benchmark"))
    entry = run.editor.edit_batch_async
    mend = faults.FAULTS["rows_mixed"](run.editor)
    try:
        samples = harness.drive(run)
    finally:
        mend()
    assert run.editor.edit_batch_async == entry  # mended
    checks = harness.judge(run, samples)
    assert not harness.verdict(checks), checks


def test_a_serve_run_whose_arrivals_fell_behind_fails(root, monkeypatch):
    monkeypatch.setattr(harness, "LATE_LIMIT_S", 0.0)
    with pytest.raises(harness.HarnessError, match="fell behind"):
        harness.run_cell(tiny_root.SERVE, 5, 1.5, False, "cpu",
                         here=os.path.join(root, "benchmark"))


def test_serve_sample_takes_half_from_shared_batches():
    rng = np.random.default_rng(2 ** 31 + 1)
    shared = {3, 5, 7, 9, 11, 13}
    keys = drivers.sample_keys(rng, list(range(40)), shared, 8)
    assert len(set(keys)) == 8 and len(set(keys) & shared) == 4 and keys == sorted(keys)
    assert len(drivers.sample_keys(rng, list(range(40)), set(), 8)) == 8
    keys = drivers.sample_keys(rng, list(range(10)), set(range(9)), 8)  # one alone
    assert len(set(keys)) == 8 and len(set(keys) & set(range(9))) >= 7
    assert drivers.sample_keys(rng, [4, 6], {4}, 8) == [4, 6]
