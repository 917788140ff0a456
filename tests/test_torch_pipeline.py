"""The slice as a whole: the port's tiny editor against the JAX package's.

Both editors hold the same weights (the JAX tiny editor's parameters,
carried across by ``tools/from_jax``) and the same noise (the JAX editor's
own ``jax.random`` draws, rebuilt in the order its edit program splits its
key).  Both run fp32 on the CPU.  Tolerance: the uint8 images differ by at
most 1 LSB (fp32 op-order differences can move a value across a rounding
boundary).  Also: the config-derived call inventory equals the calls the
port actually makes, and the editor's constructor rules.
"""

from collections import Counter

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from fastedit_tpu.models import configs as JC

import fastedit_tpu_torch.models.resnet as tresnet
from fastedit_tpu_torch import FastEditor
from fastedit_tpu_torch import ops as tops
from fastedit_tpu_torch.models import configs as TC
from fastedit_tpu_torch.tools import from_jax, inventory


def _img(seed, n=64):
    r = np.random.default_rng(seed)
    img = r.integers(60, 200, (n, n, 3)).astype(np.int32)
    img[10:40, 12:30] += 50  # a block: Canny finds edges at the default thresholds
    return Image.fromarray(np.clip(img, 0, 255).astype(np.uint8), "RGB")


def _jax_noise(seed, shape, num_steps):
    """The JAX edit program's draws: edit_core splits k_enc (posterior eps),
    then the denoise loop k_init and one k_step per step."""
    key = jax.random.PRNGKey(seed)
    key, k_enc = jax.random.split(key)
    draws = [jax.random.normal(k_enc, shape)]
    key, k_init = jax.random.split(key)
    draws.append(jax.random.normal(k_init, shape))
    for _ in range(num_steps):
        key, k_step = jax.random.split(key)
        draws.append(jax.random.normal(k_step, shape))
    t = [torch.from_numpy(np.array(d)) for d in draws]
    return t[0], t[1], t[2:]


def carried_editors(jed):
    """The JAX tiny editor ``jed`` and a port tiny editor holding its
    weights and drawing its noise."""
    m = jed.modules
    ted = FastEditor("tiny", device="cpu", dtype=torch.float32)
    tm = ted.modules
    host = jax.device_get
    tm.unet.load_state_dict(from_jax.unet_state_dict(host(m.unet_params), TC.TINY_UNET))
    tm.controlnet.load_state_dict(
        from_jax.controlnet_state_dict(host(m.controlnet_params), TC.TINY_CONTROLNET))
    tm.vae.load_state_dict(from_jax.vae_state_dict(host(m.vae_params), TC.TINY_VAE))
    tm.text_encoder.load_state_dict(
        from_jax.clip_text_state_dict(host(m.text_encoder_params), TC.TINY_TEXT_ENCODER))
    tm.text_encoder_2.load_state_dict(
        from_jax.clip_text_state_dict(host(m.text_encoder_2_params), TC.TINY_TEXT_ENCODER_2))
    ted._noise = _jax_noise
    return jed, ted


@pytest.fixture(scope="module")
def editors(tiny_editor_f32):
    return carried_editors(tiny_editor_f32)


def _assert_within_1_lsb(a, b):
    d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    assert d.max() <= 1, f"max diff {d.max()} LSB, {np.mean(d > 0):.2%} of values differ"


def test_tiny_edit_matches_jax_editor(editors):
    jed, ted = editors
    kw = dict(seed=7, guidance_scale=1.5, strength=0.8, num_inference_steps=4)
    ref = jed.edit(_img(0), "a red bicycle", **kw)
    out = ted.edit(_img(0), "a red bicycle", **kw)
    assert out.size == (64, 64) and out.mode == "RGB"
    _assert_within_1_lsb(out, ref)


def test_tiny_edit_batch_matches_jax_editor(editors):
    """Two images with two prompts: pair-interleaved CFG, the conditioning
    tower at batch B, same-seed noise tiled over the batch, per-image
    decode."""
    jed, ted = editors
    imgs, prompts = [_img(1), _img(2)], ["a cat", "a small dog"]
    ref = jed.edit_batch(imgs, prompts, seed=3, negative_prompt="blurry")
    out = ted.edit_batch(imgs, prompts, seed=3, negative_prompt="blurry")
    for a, b in zip(out, ref):
        _assert_within_1_lsb(a, b)


def test_preprocess_image_matches_jax_editor(editors):
    jed, ted = editors
    np.testing.assert_array_equal(np.asarray(ted.preprocess_image(_img(4))),
                                  np.asarray(jed.preprocess_image(_img(4))))


def test_call_inventory_matches_the_calls_an_edit_makes(editors, monkeypatch):
    """Every 3x3 stride-1 conv module call (an upsampler's at its 2x size,
    whether the up2 kernel serves it or not) and every attention call."""
    _, ted = editors
    conv, attn = Counter(), Counter()
    real_conv, real_attn = tresnet.Conv3x3.forward, tops.attention

    def rec_conv(self, x, *args, up2=False, **kwargs):
        n, h, w, _ = x.shape
        key = (n, 2 * h, 2 * w) if up2 else (n, h, w)
        conv[(*key, self.in_channels, self.out_channels)] += 1
        return real_conv(self, x, *args, up2=up2, **kwargs)

    def rec_attn(q, k, v, scale=None):
        b, sq, h, d = q.shape
        attn[(b, sq, k.shape[1], h, d)] += 1
        return real_attn(q, k, v, scale=scale)

    monkeypatch.setattr(tresnet.Conv3x3, "forward", rec_conv)
    monkeypatch.setattr(tops, "attention", rec_attn)
    ted.edit(_img(5), "a boat", seed=1)
    exp_conv, exp_attn = inventory.edit_calls(
        TC.TINY_UNET, TC.TINY_CONTROLNET, TC.TINY_VAE, 64, batch=1, steps=3,
        control_res=ted._control_res)
    assert conv == exp_conv
    assert attn == exp_attn
    conv.clear()
    attn.clear()
    ted.edit_batch([_img(5), _img(6)], ["a", "b"], seed=1)
    exp_conv, exp_attn = inventory.edit_calls(
        TC.TINY_UNET, TC.TINY_CONTROLNET, TC.TINY_VAE, 64, batch=2, steps=3,
        control_res=ted._control_res)
    assert conv == exp_conv
    assert attn == exp_attn


def test_editor_constructor_rules():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            FastEditor("tiny")  # device=None means the card
    with pytest.raises(ValueError):
        FastEditor("nope", device="cpu")
    with pytest.raises(FileNotFoundError, match="Checkpoint directory not found"):
        FastEditor("ssd-1b", device="cpu", checkpoint_dir="no/such/checkpoint")
    ed = FastEditor("tiny", device="cpu", dtype="float16")
    assert ed.dtype == torch.bfloat16
    assert FastEditor.MODEL_CONFIGS.keys() == {"sdxl", "ssd-1b", "tiny"}
    assert repr(FastEditor.MODEL_CONFIGS["ssd-1b"]["unet_config"]) == repr(JC.SSD1B_UNET)
    assert ed.get_memory_usage()["allocated_gb"] == 0.0


def test_batch_entry_points_give_the_same_images(editors):
    """One seed through ``edit_batch`` on PIL images, on a pre-resized uint8
    array, on ``stage_inputs``'s tensor, and through ``edit_batch_async``'s
    ``result()`` and ``local_result()``: the same uint8 images."""
    _, ted = editors
    imgs, prompts = [_img(1), _img(2)], ["a cat", "a small dog"]
    arr = np.stack([np.asarray(im) for im in imgs])
    kw = dict(seed=3, negative_prompt="blurry")
    ref = np.stack([np.asarray(o) for o in ted.edit_batch(imgs, prompts, **kw)])
    staged = ted.stage_inputs(arr)
    assert staged.dtype == torch.uint8 and tuple(staged.shape) == arr.shape
    pending = ted.edit_batch_async(staged, prompts, **kw)
    rows = ted.edit_batch_async(arr, prompts, **kw).local_result()
    for out in (ted.edit_batch(arr, prompts, **kw), ted.edit_batch(staged, prompts, **kw),
                pending.result()):
        np.testing.assert_array_equal(np.stack([np.asarray(o) for o in out]), ref)
    assert [r for r, _ in rows] == [0, 1]
    np.testing.assert_array_equal(np.stack([np.asarray(o) for _, o in rows]), ref)


def test_batch_entry_points_reject_what_the_jax_editor_rejects(editors):
    """Wrong shapes and dtypes raise ValueError in both editors, before any
    work; unequal image and prompt counts raise in both."""
    jed, ted = editors
    good = np.zeros((2, 64, 64, 3), np.uint8)
    bad = {
        "float array": good.astype(np.float32),
        "other size": np.zeros((2, 32, 32, 3), np.uint8),
        "no channels": np.zeros((2, 64, 64), np.uint8),
    }
    for what, arr in bad.items():
        for ed in (jed, ted):
            with pytest.raises(ValueError):
                ed.edit_batch(arr, ["a", "b"], seed=0)
    for ed in (jed, ted):
        with pytest.raises(ValueError):
            ed.stage_inputs(np.zeros((2, 32, 32, 3), np.uint8))
        with pytest.raises((ValueError, AssertionError)):
            ed.edit_batch(good, ["a"], seed=0)
    with pytest.raises(ValueError):  # a staged batch of another dtype
        ted.edit_batch(torch.zeros((2, 64, 64, 3), dtype=torch.float32), ["a", "b"])
    with pytest.raises(ValueError):
        jed.edit_batch(jax.numpy.zeros((2, 64, 64, 3), jax.numpy.float32), ["a", "b"])
