"""The port's PIE-Bench harness, demo data and CLI parsers against the JAX
package's, on the same inputs.

Exact: ``safe_join``, ``select_entries``, ``write_metrics_csv`` (byte for
byte), ``summarize`` (equal, and the shipped ``examples/tiny_results``
summary reproduced at rel 1e-9), the suffix helpers and the demo dataset
(byte for byte).  Every port CLI parser has every flag of its JAX
counterpart with the same default; the one named exception is
``evaluate --device``, whose default is the card (``cuda``) where the JAX
package's is ``tpu``.  Also: ``FASTEDIT_PLATFORM``'s reading, the PIL
comparison figures and their file names, ``utils/profiling``'s stage timer
report and memory keys against the JAX package's, and the lazy
``MetricsCalculator`` export.
"""

import csv
import importlib
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from fastedit_tpu import harness as jharness
from fastedit_tpu.tools import make_demo_data as jdemo

from fastedit_tpu_torch import harness
from fastedit_tpu_torch import evaluate as tevaluate
from fastedit_tpu_torch import run_batch as trun_batch
from fastedit_tpu_torch import run_single_image as trun_single
from fastedit_tpu_torch.plotting import compare_methods as tcompare
from fastedit_tpu_torch.tools import make_demo_data as tdemo

REPO = Path(__file__).resolve().parents[1]
TINY_RESULTS = REPO / "examples" / "tiny_results"


def _root_module(name: str, rel: str):
    """A root script of the JAX package, loaded from its file."""
    spec = importlib.util.spec_from_file_location(f"jax_cli_{name}", REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, str(REPO))
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path", ["cat/img.jpg", "a/b/../c.jpg", "x.jpg", "../x.jpg",
                                  "/etc/passwd", "a/../../x.jpg", ".."])
def test_safe_join_matches_jax(tmp_path, path):
    try:
        ref = jharness.safe_join(str(tmp_path), path)
    except ValueError:
        with pytest.raises(ValueError):
            harness.safe_join(str(tmp_path), path)
        return
    assert harness.safe_join(str(tmp_path), path) == ref


MAPPING = {
    "a": {"image_path": "1.jpg", "editing_type_id": "0", "editing_prompt": "x"},
    "b": {"image_path": "2.jpg", "editing_type_id": "1", "editing_prompt": "y"},
    "c": {"image_path": "3.jpg", "editing_type_id": "0", "editing_prompt": "z"},
}


@pytest.mark.parametrize("kw", [
    dict(image_ids=["c", "a", "nope"]), dict(editing_types=["0"]), dict(num_images=2),
    dict(editing_types=["1", "0"], num_images=1), dict(), dict(num_images=5),
])
def test_select_entries_matches_jax(kw):
    assert harness.select_entries(MAPPING, **kw) == jharness.select_entries(MAPPING, **kw)


def _shipped_rows():
    with open(TINY_RESULTS / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        for m in harness.METRIC_NAMES:
            r[m] = float(r[m])
    return rows


def _assert_same(ours, ref, path=""):
    assert isinstance(ours, dict) == isinstance(ref, dict), path
    if isinstance(ours, dict):
        assert set(ours) == set(ref), (path, set(ours) ^ set(ref))
        for k in ours:
            _assert_same(ours[k], ref[k], f"{path}.{k}")
    elif isinstance(ours, float):
        assert ours == pytest.approx(ref, rel=1e-9, abs=1e-12), (path, ours, ref)
    else:
        assert ours == ref, (path, ours, ref)


def test_summarize_reproduces_the_shipped_summary():
    rows = _shipped_rows()
    ours = harness.summarize(rows)
    _assert_same(ours, json.loads((TINY_RESULTS / "summary.json").read_text()))
    assert ours == jharness.summarize(rows)


def test_write_metrics_csv_and_summary_byte_for_byte(tmp_path):
    rows = _shipped_rows()
    harness.write_metrics_csv(str(tmp_path / "t" / "metrics.csv"), rows)
    jharness.write_metrics_csv(str(tmp_path / "j" / "metrics.csv"), rows)
    assert (tmp_path / "t" / "metrics.csv").read_bytes() == (
        tmp_path / "j" / "metrics.csv").read_bytes()
    harness.write_summary(str(tmp_path / "t" / "summary.json"), harness.summarize(rows))
    jharness.write_summary(str(tmp_path / "j" / "summary.json"), jharness.summarize(rows))
    assert (tmp_path / "t" / "summary.json").read_bytes() == (
        tmp_path / "j" / "summary.json").read_bytes()
    assert harness.CSV_FIELDS == jharness.CSV_FIELDS


@pytest.mark.parametrize("model", ["sdxl", "ssd-1b", "tiny"])
@pytest.mark.parametrize("full", [False, True])
def test_model_suffix_matches_jax(model, full):
    assert harness.model_suffix(model, full) == jharness.model_suffix(model, full)


@pytest.mark.parametrize("path", ["outputs/batch/edited/sdxl_fp16", "out/ssd-1b_fp32/",
                                  "outputs/batch/edited", "x/tiny_bf16", "tiny_fp16"])
def test_detect_model_suffix_matches_jax(path):
    assert harness.detect_model_suffix(path) == jharness.detect_model_suffix(path)


@pytest.mark.parametrize("n,size,seed", [(6, 64, 0), (4, 32, 3)])
def test_make_demo_data_byte_for_byte(tmp_path, n, size, seed):
    assert tdemo.main(["--out", str(tmp_path / "t"), "--n", str(n), "--size", str(size),
                       "--seed", str(seed)]) == 0
    jdemo.make_demo_dataset(str(tmp_path / "j"), n, size, seed)
    ours = sorted(p.relative_to(tmp_path / "t") for p in (tmp_path / "t").rglob("*")
                  if p.is_file())
    ref = sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*")
                 if p.is_file())
    assert ours == ref and len(ours) == n + 1
    for rel in ours:
        assert (tmp_path / "t" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes(), rel


def _defaults(parser) -> dict:
    return {o: a.default for a in parser._actions for o in a.option_strings
            if o.startswith("--") and o != "--help"}


@pytest.mark.parametrize("port,rel", [
    (trun_single, "run_single_image.py"), (trun_batch, "run_batch.py"),
    (tevaluate, "evaluate.py"), (tcompare, "plotting/compare_methods.py"),
])
def test_cli_flags_and_defaults_match_jax(port, rel):
    ours = _defaults(port.build_parser())
    ref = _defaults(_root_module(Path(rel).stem, rel).build_parser())
    assert set(ours) == set(ref)
    if rel == "evaluate.py":  # the one named exception: the card, not the TPU
        assert (ours.pop("--device"), ref.pop("--device")) == ("cuda", "tpu")
    assert ours == ref
    assert tcompare.METHODS == _root_module("compare_methods",
                                            "plotting/compare_methods.py").METHODS


@pytest.mark.parametrize("platform,requested,expected", [
    (None, None, None), (None, "cpu", "cpu"), (None, "cuda", "cuda"), ("cpu", None, "cpu"),
    ("cpu", "cuda", "cpu"), ("", "cuda", "cuda"), ("tpu", None, ValueError),
    ("cuda", None, ValueError),
])
def test_entry_device(monkeypatch, platform, requested, expected):
    if platform is None:
        monkeypatch.delenv("FASTEDIT_PLATFORM", raising=False)
    else:
        monkeypatch.setenv("FASTEDIT_PLATFORM", platform)
    if expected is ValueError:
        with pytest.raises(ValueError, match="FASTEDIT_PLATFORM"):
            harness.entry_device(requested)
    else:
        assert harness.entry_device(requested) == expected


def _save(path, seed, size=48):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8), "RGB").save(path)


def test_save_comparison_draws_both_panels(tmp_path):
    src = Image.fromarray(np.full((64, 64, 3), (200, 20, 20), np.uint8))
    edited = np.full((64, 64, 3), (20, 20, 200), np.uint8)
    path = tmp_path / "cmp" / "c.png"
    harness.save_comparison(str(path), src, edited, "tiny", "a prompt " * 20)
    fig = np.asarray(Image.open(path).convert("RGB"))
    h, w, _ = fig.shape
    assert w > 2 * harness.PANEL and h > harness.PANEL
    # the source fills the left panel, the edited image the right one
    assert tuple(fig[h - harness.MARGIN - harness.PANEL // 2, w // 4]) == (200, 20, 20)
    assert tuple(fig[h - harness.MARGIN - harness.PANEL // 2, 3 * w // 4]) == (20, 20, 200)
    # a title above each panel
    assert fig[: h - harness.MARGIN - harness.PANEL].min() < 128


def _tree(tmp_path):
    image_id = "000000000042"
    rel = "0/random/042.jpg"
    _save(str(tmp_path / "src" / rel), 1)
    for m, s in [("ssd-1b_fp16", 2), ("sdxl_fp16", 3), ("tiny_fp16", 4)]:
        _save(str(tmp_path / "out" / m / rel), s)
    (tmp_path / "mapping.json").write_text(
        json.dumps({image_id: {"image_path": rel, "editing_prompt": "a cat"}}))
    return image_id


@pytest.mark.parametrize("methods,name", [
    (None, "comparison_all_{}.png"),
    (["ssd-1b_fp16", "sdxl_fp16"], "comparison_ssd-1b_fp16_vs_sdxl_fp16_{}.png"),
    (["ssd-1b_fp16", "sdxl_fp16", "tiny_fp16"], "comparison_all_{}.png"),
    (["sdxl_fp32"], None),
])
def test_compare_methods_file_names(tmp_path, methods, name):
    image_id = _tree(tmp_path)
    argv = ["--image_id", image_id, "--mapping_file", str(tmp_path / "mapping.json"),
            "--source_dir", str(tmp_path / "src"), "--outputs_dir", str(tmp_path / "out"),
            "--figures_dir", str(tmp_path / "figures")] + (
        ["--methods", *methods] if methods else [])
    out = tcompare.plot_comparison(tcompare.build_parser().parse_args(argv))
    if name is None:
        assert out is None and tcompare.main(argv) == 1
        return
    assert out == str(tmp_path / "figures" / name.format(image_id))
    panels = 1 + (3 if methods is None else len(methods))
    assert Image.open(out).width == panels * (harness.PANEL + harness.MARGIN) + harness.MARGIN


def test_stage_timer_and_memory_stats_match_jax(monkeypatch):
    import torch

    from fastedit_tpu.utils import profiling as jprofiling

    from fastedit_tpu_torch.utils import profiling

    timers = [profiling.StageTimer(), jprofiling.StageTimer()]
    clock = iter([0.0, 0.25, 1.0, 1.5, 2.0, 2.125] * 2)
    monkeypatch.setattr("time.perf_counter", lambda: next(clock))
    for timer in timers:
        for name in ("denoise", "decode", "denoise"):
            with timer.stage(name, result=torch.zeros(2) if timer is timers[0] else None):
                pass
    assert timers[0].report() == timers[1].report()
    assert timers[0].totals == {"denoise": 0.375, "decode": 0.5}
    stats = profiling.device_memory_stats("cpu")
    assert set(stats) == {"bytes_in_use_gb", "peak_bytes_in_use_gb", "bytes_limit_gb"}
    assert set(stats.values()) == {0.0}


def test_metrics_calculator_is_exported():
    import fastedit_tpu_torch
    from fastedit_tpu_torch.metrics.calculator import MetricsCalculator

    assert "MetricsCalculator" in fastedit_tpu_torch.__all__
    assert fastedit_tpu_torch.MetricsCalculator is MetricsCalculator
    mod = importlib.import_module("fastedit_tpu_torch")
    with pytest.raises(AttributeError):
        mod.NotAName  # noqa: B018
