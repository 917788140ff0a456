"""The port's six metrics against the JAX package's, on the CPU.

The JAX calculator (``tiny=True``) makes its random backbones; they are
saved as a converted checkpoint directory (the JAX package's
``save_params``) and the port's calculator loads them from there, through
``utils/checkpoint.load_params`` and ``tools/from_jax``.  Both then score
the same PIL images.  Tolerances: SSIM, PSNR and MSE to 1e-5 absolute (both
fp32, summed in other orders); LPIPS, CLIP score and DINO distance to 1e-4
relative (deep fp32 networks: the order of sums moves the last bits, layer
after layer).  Also: the batch against the per-pair calls (the JAX
package's own limits, ``tests/test_metrics_batch.py``), the fail-closed NaN
path, the CLIP tokenizer's path and the TF32 context.  The learned metrics
run the port's CLIP vision and text towers, DINO ViT and LPIPS-Squeeze, so
their agreement holds those modules to the JAX package's.
"""

import math

import numpy as np
import pytest
import torch
from PIL import Image

import fastedit_tpu.metrics.calculator as jcalc_mod
from fastedit_tpu.metrics.calculator import MetricsCalculator as JCalculator
from fastedit_tpu.models import configs as JC
from fastedit_tpu.utils import checkpoint as jckpt

import chip_smoke
import fastedit_tpu_torch.metrics.calculator as tcalc_mod
from fastedit_tpu_torch.metrics import MetricsCalculator
from fastedit_tpu_torch.metrics import functional as F
from fastedit_tpu_torch.metrics.calculator import true_fp32
from fastedit_tpu_torch.models import configs as TC

PIXEL_ATOL = 1e-5
LEARNED_RTOL = 1e-4
PIXEL = ("ssim", "psnr", "mse")
LEARNED = ("lpips", "clip_score", "dino_distance")
BACKBONES = ("lpips", "clip_vision", "clip_text", "dino")


def _pil(seed, size=(64, 64)):
    r = np.random.default_rng(seed)
    img = r.integers(0, 256, (size[1], size[0], 3)).astype(np.int32)
    img[8:40, 10:30] = r.integers(0, 256, 3)  # a block, so the pair has structure
    return Image.fromarray(np.clip(img, 0, 255).astype(np.uint8), "RGB")


def _noisy(img, seed, sigma):
    r = np.random.default_rng(seed)
    arr = np.asarray(img, np.float32) + r.normal(0, sigma, (img.size[1], img.size[0], 3))
    return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8), "RGB")


PAIRS = [(_pil(1), _noisy(_pil(1), 2, 12.0), "the cat and the hat"),
         (_pil(3, (96, 48)), _pil(4, (40, 72)), "an orchard at dusk"),
         (_pil(5, (512, 512)), _noisy(_pil(5, (512, 512)), 6, 40.0), "a lighthouse")]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX tiny calculator and its random backbones saved as converted
    checkpoints under one weights directory."""
    jcalc = JCalculator(device="cpu", tiny=True)
    d = tmp_path_factory.mktemp("metrics_weights")
    for name in BACKBONES:
        jckpt.save_params(str(d / name), jcalc._backbone(name))
    return jcalc, d


@pytest.fixture(scope="module")
def calcs(weights):
    jcalc, d = weights
    return jcalc, MetricsCalculator(device="cpu", weights_dir=str(d), tiny=True)


def _close(name, got, want):
    if name in PIXEL:
        assert got == pytest.approx(want, abs=PIXEL_ATOL), name
    else:
        assert got == pytest.approx(want, rel=LEARNED_RTOL, abs=1e-12), name


@pytest.mark.parametrize("pair", range(len(PAIRS)))
def test_all_metrics_match_jax(calcs, pair):
    jcalc, tcalc = calcs
    src, edt, prompt = PAIRS[pair]
    want = jcalc.calculate_all_metrics(src, edt, prompt)
    got = tcalc.calculate_all_metrics(src, edt, prompt)
    assert sorted(got) == sorted(want)
    for k in want:
        assert math.isfinite(got[k]), k
        _close(k, got[k], want[k])
    assert got["lpips"] != 0 and got["dino_distance"] != 0
    one_by_one = {"ssim": tcalc.calculate_ssim(src, edt), "psnr": tcalc.calculate_psnr(src, edt),
                  "mse": tcalc.calculate_mse(src, edt), "lpips": tcalc.calculate_lpips(src, edt),
                  "clip_score": tcalc.calculate_clip_score(edt, prompt),
                  "dino_distance": tcalc.calculate_dino_distance(src, edt)}
    for k, v in one_by_one.items():
        _close(k, got[k], v)


def test_an_image_against_itself(calcs):
    _, tcalc = calcs
    img = PAIRS[0][0]
    assert tcalc.calculate_ssim(img, img) == 1.0
    assert tcalc.calculate_psnr(img, img) == math.inf
    assert tcalc.calculate_mse(img, img) == 0.0
    assert tcalc.calculate_lpips(img, img) == 0.0
    assert tcalc.calculate_dino_distance(img, img) == 0.0


def test_batch_matches_the_per_pair_calls_and_jax(calcs):
    jcalc, tcalc = calcs
    srcs, edts, prompts = (list(x) for x in zip(*PAIRS))
    batch = tcalc.calculate_all_metrics_batch(srcs, edts, prompts)
    jbatch = jcalc.calculate_all_metrics_batch(srcs, edts, prompts)
    for i, (s, e, p) in enumerate(PAIRS):
        single = tcalc.calculate_all_metrics(s, e, p)
        for k in single:
            np.testing.assert_allclose(batch[i][k], single[k], rtol=2e-4, atol=2e-5,
                                       err_msg=f"{k}[{i}]")
            _close(k, batch[i][k], jbatch[i][k])
    with pytest.raises(ValueError):
        tcalc.calculate_all_metrics_batch(srcs, edts[:2], prompts)


def test_fails_closed_without_converted_weights(tmp_path):
    """Full-size backbones, no weights: the learned metrics report NaN and
    nothing is built; the pixel metrics are exact and match the JAX
    calculator's."""
    with pytest.warns(UserWarning, match="DISABLED"):
        closed = MetricsCalculator(device="cpu", weights_dir=str(tmp_path))
    assert closed.random_backbones == BACKBONES and not closed.learned_enabled
    assert not closed._ready
    jclosed = JCalculator(device="cpu", weights_dir=str(tmp_path))
    src, edt, prompt = PAIRS[0]
    got, want = (c.calculate_all_metrics(src, edt, prompt) for c in (closed, jclosed))
    for k in LEARNED:
        assert math.isnan(got[k]) and math.isnan(want[k]), k
    for k in PIXEL:
        _close(k, got[k], want[k])
    rows = closed.calculate_all_metrics_batch([src], [edt], [prompt])
    assert all(math.isnan(rows[0][k]) for k in LEARNED)
    assert rows[0]["ssim"] == pytest.approx(got["ssim"], abs=PIXEL_ATOL)
    assert not closed._ready


def test_random_fallback_is_explicit_and_lazy(tmp_path):
    with pytest.warns(UserWarning, match="RANDOM"):
        calc = MetricsCalculator(device="cpu", weights_dir=str(tmp_path), allow_random=True,
                                 init_seed=3)
    assert calc.learned_enabled and not calc._ready
    calc.calculate_mse(PAIRS[0][0], PAIRS[0][1])
    assert not calc._ready  # nothing built for a pixel metric


@pytest.fixture
def small_backbones(monkeypatch):
    """Both calculators' full-size backbone configs replaced by the tiny
    ones, so the non-tiny paths (converted weights, tokenizer) run small."""
    for mod, configs in ((tcalc_mod, TC), (jcalc_mod, JC)):
        monkeypatch.setattr(configs, "CLIP_B16_VISION", configs.TINY_CLIP_VISION)
        monkeypatch.setattr(configs, "CLIP_B16_TEXT", configs.TINY_CLIP_TEXT)
        monkeypatch.setattr(mod, "DINO_VITB8", mod.TINY_DINO)


def test_clip_tokenizer_path(weights, small_backbones, tmp_path):
    """Converted CLIP weights without a tokenizer fail closed (NaN) in both
    packages; with ``clip_tokenizer/`` beside them, the real vocabulary is
    used, and the scores match."""
    _, d = weights
    with pytest.warns(UserWarning, match="no tokenizer"):
        closed = MetricsCalculator(device="cpu", weights_dir=str(d))
    assert "clip_tokenizer" in closed.random_backbones and not closed.learned_enabled
    assert math.isnan(closed.calculate_clip_score(*PAIRS[0][1:]))

    chip_smoke.write_tokenizer(d / "clip_tokenizer", vocab_size=1000)
    try:
        tcalc = MetricsCalculator(device="cpu", weights_dir=str(d))
        jcalc = JCalculator(device="cpu", weights_dir=str(d))
    finally:
        for f in (d / "clip_tokenizer").iterdir():
            f.unlink()
        (d / "clip_tokenizer").rmdir()
    assert tcalc.learned_enabled and tcalc.random_backbones == ()
    text = "the cat and the hat"
    ids = tcalc.clip_tokenizer.encode(text)
    np.testing.assert_array_equal(ids, jcalc.clip_tokenizer.encode(text))
    assert not np.array_equal(ids, closed.clip_tokenizer.encode(text))  # merges applied
    for img in (PAIRS[0][1], PAIRS[2][1]):
        _close("clip_score", tcalc.calculate_clip_score(img, text),
               jcalc.calculate_clip_score(img, text))


@pytest.mark.parametrize("matmul,cudnn", [(True, True), (True, False), (False, True)])
def test_true_fp32_turns_tf32_off_and_restores(matmul, cudnn):
    backends = torch.backends
    saved = backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32
    try:
        backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32 = matmul, cudnn
        with true_fp32():
            assert not backends.cuda.matmul.allow_tf32 and not backends.cudnn.allow_tf32
        assert (backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32) == (matmul, cudnn)
        with pytest.raises(RuntimeError):
            with true_fp32():
                raise RuntimeError("inside")
        assert (backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32) == (matmul, cudnn)
    finally:
        backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32 = saved


def test_functional_against_closed_forms():
    x = torch.full((1, 32, 32, 1), 0.4)
    y = torch.full((1, 32, 32, 1), 0.6)
    c1, c2 = 0.01**2, 0.03**2
    expected = ((2 * 0.4 * 0.6 + c1) * c2) / ((0.4**2 + 0.6**2 + c1) * c2)
    assert float(F.ssim(x, y)) == pytest.approx(expected, rel=1e-4)  # tests/test_metrics.py
    assert float(F.mse(x, y)) == pytest.approx(0.04, rel=1e-6)
    assert float(F.psnr(x, y)) == pytest.approx(10 * math.log10(1 / 0.04), rel=1e-5)
    both = torch.cat([x, y]), torch.cat([y, y])
    np.testing.assert_allclose(F.mse(*both, per_image=True).numpy(), [0.04, 0.0], atol=1e-7)
