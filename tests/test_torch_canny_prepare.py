"""Canny prepare (``ops/canny.py``, ``pipeline/stages.prepare``) and the
edit's graph inputs (``pipeline/graphs.EditInputs``) on the CPU.

The port's plain prepare, fed its thresholds as int32 tensors, against the
JAX package's ``canny_jax`` and ``canny_np``: the edges bit for bit, over
threshold pairs with floats and ``low > high``, on random and on smooth
images; the VAE input bit for bit in bf16 against the JAX package's
``prepare_one`` (fp32 within one ulp: XLA divides by 127.5 as a product with
its reciprocal).  The plain hysteresis against ``canny_np``'s flood fill and
``scipy.ndimage.label`` on stress masks: a serpentine of ~2,000 pixels with
one strong end whose turns link through corners only, a zigzag whose every
link is through a corner, and random candidates at densities 0.1 to 0.6.
The chain of four stages (prepare first) on the CPU gives the image the
stages give one by one, and two edits with other thresholds each see their
own ``canny_np`` edges.  The kernels themselves run only on the card:
``tests/test_torch_cuda.py`` holds them to these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from scipy import ndimage

from fastedit_tpu.ops.canny import _hysteresis as jax_hysteresis
from fastedit_tpu.ops.canny import canny_jax
from fastedit_tpu.ops.canny import canny_np as jax_canny_np
from fastedit_tpu_torch import FastEditor
from fastedit_tpu_torch.ops import canny
from fastedit_tpu_torch.pipeline import graphs, stages
from fastedit_tpu_torch.tools import conformance

THRESHOLDS = [(100, 200), (200, 100), (50.7, 120.2), (120.9, 50.2), (0, 0), (30, 30)]


def _random(seed, n=64):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, n, 3))
    img[10:40, 12:50] = rng.integers(0, 256, 3)
    return img.astype(np.uint8)


def _smooth(seed, n=64):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:n, :n]
    img = np.stack([xx * 4, yy * 3, (xx + yy) * 2], -1) + rng.integers(-2, 3, (n, n, 3))
    img[20:44, 16:48] += 60  # long edges on a gentle ramp
    return np.clip(img, 0, 255).astype(np.uint8)


IMAGES = {"random": _random, "smooth": _smooth}


@pytest.mark.parametrize("low,high", THRESHOLDS)
@pytest.mark.parametrize("kind", sorted(IMAGES))
def test_plain_prepare_equals_canny_jax_and_canny_np(kind, low, high):
    imgs = np.stack([IMAGES[kind](s) for s in range(2)])
    lo, hi = canny.threshold_tensors(low, high, "cpu")
    assert lo.dtype == hi.dtype == torch.int32 and lo.dim() == hi.dim() == 0
    control, vae_in = canny.prepare_plain(torch.from_numpy(imgs), lo, hi, torch.float32)
    assert control.shape == (2, 64, 64, 3) and vae_in.shape == (2, 64, 64, 3)
    assert set(np.unique(control.numpy())) <= {0.0, 1.0}
    assert torch.equal(control[..., 0], control[..., 2])
    edges = (control[..., 0].numpy() * 255).astype(np.uint8)
    for i, img in enumerate(imgs):
        want = jax_canny_np(img, low, high)
        np.testing.assert_array_equal(edges[i], want)
        got_jax = np.asarray(canny_jax(jnp.asarray(img, jnp.float32), low, high))
        np.testing.assert_array_equal(edges[i], got_jax)
    assert edges.any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_prepare_vae_input_matches_the_jax_prepare(dtype):
    from fastedit_tpu.pipeline.stages import _prepare_one_fn

    from types import SimpleNamespace

    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    mod = SimpleNamespace(unet=SimpleNamespace(dtype=jdtype))  # what _prepare_one_fn reads
    img = _random(3)
    j_control, j_vae = _prepare_one_fn(mod, 64)(jnp.asarray(img), 100, 200)
    lo, hi = canny.threshold_tensors(100, 200, "cpu")
    control, vae_in = canny.prepare_plain(torch.from_numpy(img)[None], lo, hi, dtype)
    np.testing.assert_array_equal(control[0].float().numpy(),
                                  np.asarray(j_control.astype(jnp.float32)))
    got = vae_in[0].float().numpy()
    ref = np.asarray(j_vae.astype(jnp.float32))
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(got, ref)
    else:  # one fp32 ulp (2^-24 near 1)
        assert np.abs(got - ref).max() <= 2.0**-23
    # the plain version's arithmetic: an fp32 division, then the subtraction
    f = torch.from_numpy(img).float()
    assert torch.equal(vae_in[0], (f / 127.5 - 1.0).to(dtype))


def test_threshold_tensors_floor_and_order_as_canny_np():
    assert canny.floor_thresholds(200.9, 100.2) == (100, 200)
    assert canny.floor_thresholds(-0.5, 3) == (-1, 3)
    lo, hi = canny.threshold_tensors(150.7, 50.1, torch.device("cpu"))
    assert (int(lo), int(hi)) == (50, 150)


def _flood(cls):
    return canny.flood_fill_np(cls == canny.STRONG, cls != 0)


def _label(cls):
    """The candidates whose 8-connected component holds a strong pixel."""
    labels, _ = ndimage.label(cls != 0, np.ones((3, 3), bool))
    strong = np.unique(labels[cls == canny.STRONG])
    return np.isin(labels, strong[strong > 0])


@pytest.mark.parametrize("name", ["serpentine", "zigzag", "random 0.1", "random 0.2",
                                  "random 0.3", "random 0.4", "random 0.5", "random 0.6"])
def test_plain_hysteresis_on_stress_masks(name):
    cls = dict(conformance.stress_classes(seed=1, size=64))[name]
    want = _flood(cls)
    np.testing.assert_array_equal(want, _label(cls))
    got = canny.hysteresis_plain(torch.from_numpy(cls)[None])[0].numpy()
    np.testing.assert_array_equal(got, want)
    control = canny.canny_hysteresis(torch.from_numpy(cls)[None], torch.bfloat16)
    np.testing.assert_array_equal(control[0, ..., 1].float().numpy() > 0, want)
    if name in ("serpentine", "zigzag"):
        assert want.all() == (cls != 0).all() and want[cls != 0].all()  # one chain, all grown
        # the JAX package's while_loop reaches the same fixed point
        jax_out = jax_hysteresis(jnp.asarray(cls == canny.STRONG), jnp.asarray(cls != 0))
        np.testing.assert_array_equal(np.asarray(jax_out), want)


def test_a_four_connected_hysteresis_fails_the_stress_masks():
    """Dropping the diagonal neighbours (a planted fault) leaves most of
    each chain out: the masks can see it."""
    for name in ("serpentine", "zigzag"):
        cls = dict(conformance.stress_classes(size=64))[name]
        labels, _ = ndimage.label(cls != 0)  # 4-connected
        start = labels[cls == canny.STRONG]
        four = np.isin(labels, start)
        assert four.sum() < 0.1 * (cls != 0).sum(), name
        assert not np.array_equal(four, _flood(cls))


@pytest.fixture(scope="module")
def editor():
    return FastEditor("tiny", device="cpu", dtype=torch.float32, init_seed=1)


def _inputs(editor, img_u8, low, high, seed=0, guidance=1.5):
    b = img_u8.shape[0]
    lo, hi = canny.threshold_tensors(low, high, "cpu")
    editor._encode_prompts(["a prompt", ""])
    ctx = editor._prompt_cache["a prompt"][0].expand(b, -1, -1)
    pooled = editor._prompt_cache["a prompt"][1].expand(b, -1)
    ctx_u, pooled_u = editor._prompt_cache[""]
    context = torch.stack([ctx_u.expand_as(ctx), ctx], 1).reshape(2 * b, *ctx.shape[1:])
    pooled = torch.stack([pooled_u.expand_as(pooled), pooled], 1).reshape(2 * b, -1)
    schedule = editor._schedule(4, 0.8)
    eps, init, steps = editor._noise(seed, (b, 8, 8, 4), schedule.num_steps)
    g, s = editor._const("scalars", guidance, 0.5)
    return graphs.EditInputs(torch.from_numpy(img_u8), lo, hi, eps, init, tuple(steps), context,
                             pooled, editor._const("time_ids", 2 * b), schedule, g, s, True,
                             editor._control_res)


def test_the_eager_chain_starts_with_prepare_and_gives_the_stages_image(editor):
    imgs = np.stack([_random(5), _smooth(6)])
    inp = _inputs(editor, imgs, 60, 140)
    seen = []

    def timed(name):
        seen.append(name)
        return torch.no_grad()

    latents, out = graphs.run_eager(editor.modules, inp, timed)
    assert tuple(seen) == graphs.STAGES == ("prepare", "vae_encode", "denoise", "vae_decode")
    mod = editor.modules
    control, vae_in = stages.prepare(mod, inp.images, 60, 140, editor._control_res)
    lat = stages.vae_sample(mod, vae_in, inp.eps_enc)
    lat = stages.denoise(mod, lat, inp.context, inp.pooled, inp.time_ids, control,
                         inp.schedule, inp.guidance, inp.controlnet_scale, inp.noise_init,
                         inp.step_noise, True)
    assert torch.equal(latents, lat)
    assert torch.equal(out, stages.vae_decode(mod, lat))


def test_edit_inputs_clone_and_copy_carry_the_thresholds(editor):
    inp = _inputs(editor, np.stack([_random(1)]), 100, 200)
    static = inp.clone()
    other = _inputs(editor, np.stack([_smooth(2)]), 200.5, 50.2)
    static.copy_(other)
    assert (int(static.canny_low), int(static.canny_high)) == (50, 200)
    assert torch.equal(static.images, other.images)
    assert (int(inp.canny_low), int(inp.canny_high)) == (100, 200)
    with pytest.raises(ValueError):
        static.copy_(_inputs(editor, np.stack([_random(1)] * 2), 100, 200))


def test_two_edits_with_other_thresholds_see_their_own_edges(editor, monkeypatch):
    """The editor hands each call's thresholds to prepare as int32 tensors;
    each call's control image (before the tiny ControlNet's resize) is its
    own ``canny_np`` edge map."""
    seen = []
    real = canny.prepare

    def spy(img, low, high, dtype):
        out = real(img, low, high, dtype)
        assert low.dtype == high.dtype == torch.int32
        seen.append((img.clone(), int(low), int(high), out[0].clone()))
        return out

    monkeypatch.setattr(canny, "prepare", spy)
    img = Image.fromarray(_smooth(7))
    for low, high in ((100, 200), (20, 60), (200, 100), (10.9, 30.2)):
        editor.edit(img, "a boat", seed=1, canny_low_threshold=low, canny_high_threshold=high)
    assert [(lo, hi) for _, lo, hi, _ in seen] == [(100, 200), (20, 60), (100, 200), (10, 30)]
    edges = []
    for arr, lo, hi, control in seen:
        full = (control[0, ..., 0].numpy() * 255).astype(np.uint8)
        np.testing.assert_array_equal(full, jax_canny_np(arr[0].numpy(), lo, hi))
        edges.append(full)
    assert not np.array_equal(edges[0], edges[1])
    assert np.array_equal(edges[0], edges[2])


def test_preprocess_image_goes_through_prepare(editor, monkeypatch):
    calls = []
    real = canny.prepare

    def spy(img, low, high, dtype):
        calls.append((int(low), int(high), dtype))
        return real(img, low, high, dtype)

    monkeypatch.setattr(canny, "prepare", spy)
    img = Image.fromarray(_random(8))
    out = np.asarray(editor.preprocess_image(img, 90, 180))
    assert calls == [(90, 180, torch.float32)]
    np.testing.assert_array_equal(out[..., 0], jax_canny_np(_random(8), 90, 180))
    assert out.shape == (64, 64, 3) and np.array_equal(out[..., 0], out[..., 2])
