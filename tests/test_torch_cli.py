"""The port's CLIs on the CPU (``FASTEDIT_PLATFORM=cpu``, the tiny model, 64²
demo images), against the JAX package's root scripts where both run.

* ``run_batch``: the port's ``main`` and the JAX ``run_batch.main`` sweep
  the same images with the same seed and flags, each editor holding the JAX
  tiny editor's fp32 weights and drawing its noise (the carried editors of
  ``test_torch_pipeline.py``).  Before JPEG the images differ by at most 1
  LSB (fp32 op order, ``test_torch_pipeline.py``); both CLIs save with PIL's
  JPEG at its default quality 75, whose 8x8 DCT quantisation can turn a 1
  LSB input difference into a few LSB after decoding.  Tolerance: decoded
  outputs within ``JPEG_MAX_LSB`` per value and ``JPEG_MEAN_LSB`` on
  average.  On these inputs the two sweeps' JPEGs decode to the same
  values (0 LSB): the editors agree exactly before the codec here.
* ``--data_parallel`` over two CPU replicas: bit for bit the sequential
  sweep's outputs (one row per replica, the same seed: the same noise and
  the same batch-1 program); ``edit_batch`` over the group against one
  editor's ``edit_batch`` of the chunk within 1 LSB (fp32).
* ``evaluate``: the port's and the JAX ``evaluate.main`` on the same files,
  SSIM, PSNR and MSE at rtol = atol = 2e-4, the learned metrics NaN in both
  (no converted weights: fail closed), the same summary keys.
* ``run_single_image --compute_metrics --profile``, ``run_benchmark tiny``
  (the ``examples/tiny_results`` artifact schemas), the sweep loader's
  per-image isolation, the NaN checks, and the refusals.
"""

import csv
import importlib.util
import json
import math
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from fastedit_tpu.parallel.batch import _load_chunk as jax_load_chunk
from test_torch_pipeline import carried_editors

import fastedit_tpu
from fastedit_tpu_torch import evaluate as tevaluate
from fastedit_tpu_torch import run_batch as trun_batch
from fastedit_tpu_torch import run_benchmark as trun_benchmark
from fastedit_tpu_torch import run_single_image as trun_single
from fastedit_tpu_torch.parallel.batch import _load_chunk
from fastedit_tpu_torch.pipeline import editor as teditor
from fastedit_tpu_torch.tools import make_demo_data
from fastedit_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
TINY_RESULTS = REPO / "examples" / "tiny_results"
JPEG_MAX_LSB = 8
JPEG_MEAN_LSB = 0.5


def _root_module(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_cli_{name}", REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, str(REPO))
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("FASTEDIT_PLATFORM", "cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tiny model gains nothing from more, and the
    suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo")
    make_demo_data.main(["--out", str(root), "--n", "3", "--size", "64"])
    return root


def _data(demo) -> list:
    return ["--mapping_file", str(demo / "mapping_file.json"),
            "--source_dir", str(demo / "annotation_images")]


def _decoded(root: Path) -> dict:
    return {str(p.relative_to(root)): np.asarray(Image.open(p), np.int32)
            for p in sorted(root.rglob("*.jpg"))}


def _keys(tree):
    """A JSON tree's key structure."""
    return {k: _keys(v) for k, v in tree.items()} if isinstance(tree, dict) else None


def _tiny_port(**kw):
    return teditor.FastEditor("tiny", device="cpu", **kw)


def test_run_batch_matches_the_jax_run_batch(demo, tmp_path, monkeypatch, tiny_editor_f32):
    jed, ted = carried_editors(tiny_editor_f32)
    monkeypatch.setattr(fastedit_tpu, "FastEditor", lambda **kw: jed, raising=False)
    monkeypatch.setattr(teditor, "FastEditor", lambda **kw: ted)
    argv = [*_data(demo), "--model", "tiny", "--seed", "7", "--negative_prompt", "blurry"]
    assert _root_module("run_batch").main([*argv, "--output_dir", str(tmp_path / "j")]) == 0
    assert trun_batch.main([*argv, "--output_dir", str(tmp_path / "t")]) == 0
    sub = Path("batch") / "edited" / "tiny_fp16"
    ref, ours = _decoded(tmp_path / "j" / sub), _decoded(tmp_path / "t" / sub)
    assert sorted(ours) == sorted(ref) and len(ours) == 3
    for rel in ours:
        d = np.abs(ours[rel] - ref[rel])
        assert d.max() <= JPEG_MAX_LSB and d.mean() <= JPEG_MEAN_LSB, (rel, d.max(), d.mean())
    for name in ("run_config.json",):
        cfg = json.loads((tmp_path / "t" / sub / name).read_text())
        assert cfg == json.loads((tmp_path / "j" / sub / name).read_text()) | {
            "output_dir": str(tmp_path / "t")}


def test_data_parallel_sweep_equals_the_sequential_sweep(demo, tmp_path, monkeypatch):
    enable = teditor.FastEditor.enable_data_parallel
    monkeypatch.setattr(teditor.FastEditor, "enable_data_parallel",
                        lambda self, devices=None, model_parallel=1:
                        enable(self, ["cpu", "cpu"], model_parallel))
    argv = [*_data(demo), "--model", "tiny", "--seed", "3", "--guidance", "1.0",
            "--save_comparisons"]
    assert trun_batch.main([*argv, "--output_dir", str(tmp_path / "seq")]) == 0
    assert trun_batch.main([*argv, "--data_parallel", "--output_dir", str(tmp_path / "dp")]) == 0
    sub = Path("batch") / "edited" / "tiny_fp16"
    seq, dp = _decoded(tmp_path / "seq" / sub), _decoded(tmp_path / "dp" / sub)
    assert sorted(dp) == sorted(seq) and len(dp) == 3
    for rel in dp:
        np.testing.assert_array_equal(dp[rel], seq[rel], err_msg=rel)
    # --save_comparisons: the writer pool draws the sequential sweep's figures
    cmp = Path("batch") / "comparisons" / "tiny_fp16"
    figures = {str(p.relative_to(tmp_path / "seq" / cmp)): np.asarray(Image.open(p))
               for p in sorted((tmp_path / "seq" / cmp).rglob("*.png"))}
    assert len(figures) == 3
    for rel, fig in figures.items():
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "dp" / cmp / rel)), fig, err_msg=rel)


def test_group_edit_batch_against_one_editor(demo):
    """Two fp32 CPU replicas: each row bit for bit its batch-1 edit, and
    within 1 LSB of one editor's batch of both (same seed: the same noise
    stream per row)."""
    images = [Image.open(p) for p in sorted((demo / "annotation_images").rglob("*.jpg"))[:2]]
    prompts = ["a red square", "a green circle"]
    single = _tiny_port(dtype=torch.float32)
    batch = single.edit_batch(images, prompts, seed=5)
    rows = [single.edit(im, p, seed=5) for im, p in zip(images, prompts)]
    dp = _tiny_port(dtype=torch.float32)
    group = dp.enable_data_parallel(["cpu", "cpu"])
    assert group.shape["data"] == 2 and group.replicas[0] is dp
    assert group.replicas[1].modules.unet is not dp.modules.unet
    out = dp.edit_batch(images, prompts, seed=5)
    staged = dp.edit_batch(dp.stage_inputs(np.stack([np.asarray(i) for i in images])),
                           prompts, seed=5)
    for o, s, r, b in zip(out, staged, rows, batch):
        np.testing.assert_array_equal(np.asarray(o), np.asarray(r))
        np.testing.assert_array_equal(np.asarray(s), np.asarray(r))
        d = np.abs(np.asarray(o, np.int32) - np.asarray(b, np.int32))
        assert d.max() <= 1
    with pytest.raises(ValueError, match="does not split"):
        dp.edit_batch(images[:1] * 3, prompts[:1] * 3, seed=5)
    # tensor parallelism: three devices do not split into groups of two
    with pytest.raises(ValueError, match="does not divide"):
        dp.enable_data_parallel(["cpu"] * 3, model_parallel=2)


def test_evaluate_matches_the_jax_evaluate(demo, tmp_path):
    edited = tmp_path / "edited"
    mapping = json.loads((demo / "mapping_file.json").read_text())
    for i, e in enumerate(mapping.values()):
        src = np.asarray(Image.open(demo / "annotation_images" / e["image_path"]), np.int32)
        noise = np.random.default_rng(i).integers(-40, 41, src.shape)
        (edited / e["image_path"]).parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(np.clip(src + noise, 0, 255).astype(np.uint8)).save(
            edited / e["image_path"])
    outs = {}
    for name, main in (("t", tevaluate.main), ("j", _root_module("evaluate").main)):
        assert main([*_data(demo), "--outputs_dir", str(edited), "--device", "cpu",
                     "--metrics_weights", str(tmp_path / "no_weights"),
                     "--results_file", str(tmp_path / name / "metrics.csv"),
                     "--summary_file", str(tmp_path / name / "summary.json")]) == 0
        with open(tmp_path / name / "metrics.csv") as f:
            outs[name] = (list(csv.DictReader(f)),
                          json.loads((tmp_path / name / "summary.json").read_text()))
    (rows, summary), (ref_rows, ref_summary) = outs["t"], outs["j"]
    assert len(rows) == len(ref_rows) == 3
    for row, ref in zip(rows, ref_rows):
        assert list(row) == list(ref)
        assert [row[k] for k in list(row)[:4]] == [ref[k] for k in list(ref)[:4]]
        for m in ("ssim", "psnr", "mse"):
            assert float(row[m]) == pytest.approx(float(ref[m]), rel=2e-4, abs=2e-4), m
        for m in ("lpips", "clip_score", "dino_distance"):
            assert math.isnan(float(row[m])) and math.isnan(float(ref[m])), m

    assert _keys(summary) == _keys(ref_summary)


def test_run_single_image_with_metrics_and_profile(demo, tmp_path):
    image = next((demo / "annotation_images").rglob("*.jpg"))
    assert trun_single.main(["--image", str(image), "--prompt", "a blue square",
                             "--model", "tiny", "--seed", "1", "--compute_metrics",
                             "--profile", str(tmp_path / "trace"),
                             "--output_dir", str(tmp_path / "out")]) == 0
    edited = tmp_path / "out" / "single" / "edited" / "tiny_fp16"
    (jpg,) = edited.glob("edited_*.jpg")
    assert Image.open(jpg).size == (64, 64)
    (metrics,) = edited.glob("metrics_*.txt")
    values = dict(line.split(": ", 1) for line in metrics.read_text().splitlines())
    for k in ("ssim", "lpips", "psnr", "mse", "clip_score", "dino_distance"):
        assert math.isfinite(float(values[k])), k
    (trace,) = (tmp_path / "trace").glob("*.json")
    assert trace.stat().st_size > 0 and "traceEvents" in trace.read_text()
    assert len(list((tmp_path / "out" / "single" / "comparisons").rglob("comparison_*.png"))) == 1
    assert not profiling.nan_checks_enabled()


@pytest.fixture
def chunk(tmp_path):
    paths = []
    for i in range(3):
        p = tmp_path / f"img_{i}.png"
        Image.fromarray(np.full((16, 16, 3), i * 40, dtype=np.uint8), "RGB").save(p)
        paths.append(str(p))
    return [(f"id{i}", {}, p, f"/out/{i}.jpg") for i, p in enumerate(paths)]


def test_load_chunk_decodes_and_resizes_as_jax(chunk):
    batch, bad = _load_chunk(chunk, 32)
    ref, ref_bad = jax_load_chunk(chunk, 32)
    assert bad == ref_bad == {}
    assert batch.shape == (3, 32, 32, 3) and batch.dtype == np.uint8
    np.testing.assert_array_equal(batch, ref)


def test_load_chunk_isolates_bad_images(chunk, tmp_path):
    broken = tmp_path / "broken.png"
    broken.write_bytes(b"not an image")
    chunk[1] = ("id1", {}, str(broken), "/out/1.jpg")
    batch, bad = _load_chunk(chunk, 32)
    assert list(bad) == [1]
    assert batch.shape == (3, 32, 32, 3)
    np.testing.assert_array_equal(batch[1], batch[0])


def test_load_chunk_all_bad(tmp_path):
    broken = tmp_path / "b.png"
    broken.write_bytes(b"junk")
    batch, bad = _load_chunk([("id0", {}, str(broken), "/out/0.jpg")], 32)
    assert batch is None and list(bad) == [0]


def test_load_chunk_staging_failure_degrades_to_host_batch(chunk):
    def exploding_stage(batch):
        raise RuntimeError("transient upload failure")

    batch, bad = _load_chunk(chunk, 32, stage=exploding_stage)
    assert bad == {}
    assert isinstance(batch, np.ndarray) and batch.shape == (3, 32, 32, 3)


def test_load_chunk_stage_result_passed_through(chunk):
    batch, bad = _load_chunk(chunk, 32, stage=lambda b: ("staged", b.shape))
    assert batch == ("staged", (3, 32, 32, 3))


@pytest.mark.parametrize("module,weight,where", [
    ("text_encoder", "text_model.embeddings.position_embedding.weight", "encode_prompt"),
    ("vae", "encoder.conv_in.weight", "vae_encode"),
    ("unet", "conv_out.weight", "denoise step 0"),
    ("vae", "decoder.conv_out.weight", "vae_decode"),
])
def test_nan_checks_name_the_stage(demo, module, weight, where):
    ed = _tiny_port()
    image = Image.open(next((demo / "annotation_images").rglob("*.jpg")))
    with torch.no_grad():
        w = getattr(ed.modules, module).get_parameter(weight)
        w[(0,) * w.dim()] = float("nan")
    ed.edit(image, "a cat", seed=0)  # off: no check, the edit runs through
    profiling.enable_nan_checks(True)
    try:
        with pytest.raises(FloatingPointError, match=f"output of {where}$"):
            ed.edit(image, "a dog", seed=0)
    finally:
        profiling.enable_nan_checks(False)


def test_run_benchmark_tiny_writes_every_artifact(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for k, v in dict(PIEBENCH_DIR="dataset", OUTPUT_DIR="outputs", RESULTS_DIR="results",
                     FIGURES_DIR="figures", N_FIGURES="2").items():
        monkeypatch.setenv(k, v)
    assert trun_benchmark.main(["tiny"]) == 0
    with open(tmp_path / "results" / "tiny_fp16" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    with open(TINY_RESULTS / "metrics.csv") as f:
        columns = next(csv.reader(f))
    assert len(rows) == 6 and list(rows[0]) == columns
    for row in rows:
        assert all(math.isfinite(float(row[m])) for m in columns[4:]), row
    summary = json.loads((tmp_path / "results" / "tiny_fp16" / "summary.json").read_text())
    shipped = json.loads((TINY_RESULTS / "summary.json").read_text())

    assert _keys(summary) == _keys(shipped) and summary["total_images"] == 6
    figures = sorted(p.name for p in (tmp_path / "figures").glob("comparison_*.png"))
    assert figures == ["comparison_all_000000000000.png", "comparison_all_000000000001.png"]
    with tarfile.open(tmp_path / "results_tiny_fp16.tar.gz") as tar:
        assert sorted(tar.getnames()) == ["results/tiny_fp16", "results/tiny_fp16/metrics.csv",
                                          "results/tiny_fp16/summary.json"]
    assert len(list((tmp_path / "outputs").rglob("*.jpg"))) == 6


def test_model_parallel_raises(demo, tmp_path, monkeypatch):
    """``--model_parallel`` runs (``tests/test_torch_tp.py``), but a device
    list it does not divide is refused before any row is edited, as the JAX
    package's ``make_mesh`` asserts."""
    enable = teditor.FastEditor.enable_data_parallel
    monkeypatch.setattr(teditor.FastEditor, "enable_data_parallel",
                        lambda self, devices=None, model_parallel=1:
                        enable(self, ["cpu"] * 3, model_parallel))
    with pytest.raises(ValueError, match="does not divide"):
        trun_batch.main([*_data(demo), "--model", "tiny", "--model_parallel", "2",
                         "--output_dir", str(tmp_path / "out")])
    assert not list((tmp_path / "out").rglob("*.jpg"))


@pytest.mark.parametrize("cli", ["run_single_image", "run_batch", "evaluate", "run_benchmark"])
@pytest.mark.parametrize("platform", ["tpu", None])
def test_no_silent_cpu_run(demo, tmp_path, monkeypatch, cli, platform):
    """``FASTEDIT_PLATFORM=tpu`` raises; unset, the entry points ask for the
    card, which this machine lacks (the editor's and the calculator's own
    error)."""
    if platform is None:
        monkeypatch.delenv("FASTEDIT_PLATFORM")
        if torch.cuda.is_available():
            pytest.skip("a card is present: the entry points would run on it")
        error = RuntimeError
    else:
        monkeypatch.setenv("FASTEDIT_PLATFORM", platform)
        error = ValueError
    image = next((demo / "annotation_images").rglob("*.jpg"))
    out = str(tmp_path / "out")
    argv = {
        "run_single_image": ["--image", str(image), "--prompt", "x", "--model", "tiny",
                             "--output_dir", out],
        "run_batch": [*_data(demo), "--model", "tiny", "--output_dir", out],
        "evaluate": [*_data(demo), "--outputs_dir", str(demo / "annotation_images")],
        "run_benchmark": ["tiny"],
    }[cli]
    module = {"run_single_image": trun_single, "run_batch": trun_batch,
              "evaluate": tevaluate, "run_benchmark": trun_benchmark}[cli]
    if cli == "run_benchmark":
        monkeypatch.chdir(tmp_path)
        monkeypatch.setenv("PIEBENCH_DIR", str(demo))
        monkeypatch.setenv("OUTPUT_DIR", out)
    with pytest.raises(error):
        module.main(argv)
