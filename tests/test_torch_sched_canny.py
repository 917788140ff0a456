"""The port's LCM scheduler and Canny against the JAX package's.

Scheduler tables must equal ``make_schedule``'s exactly over a grid of
step counts and strengths (both are fp32 numpy on the host); ``add_noise``
and ``lcm_step`` agree in fp32 to rtol = atol = 1e-6 (one fp32 rounding
order).  Canny must be bit-exact to ``canny_np`` (integer arithmetic).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastedit_tpu.ops.canny import canny_np
from fastedit_tpu.sched import lcm as jlcm

from fastedit_tpu_torch.ops.canny import canny
from fastedit_tpu_torch.sched import lcm as tlcm

TABLES = ("timesteps", "sqrt_alpha", "sqrt_one_minus_alpha", "sqrt_alpha_prev",
          "sqrt_one_minus_alpha_prev", "c_skip", "c_out", "is_last")


@pytest.mark.parametrize("steps", [1, 2, 4, 8, 25])
def test_schedule_tables_equal_jax(steps):
    for strength in (0.3, 0.5, 0.8, 1.0):
        if int(steps * strength) == 0:
            continue
        ref = jlcm.make_schedule(jlcm.LCMSchedulerConfig(), steps, strength=strength)
        out = tlcm.make_schedule(tlcm.LCMSchedulerConfig(), steps, strength=strength)
        assert out.num_steps == ref.num_steps
        for name in TABLES:
            np.testing.assert_array_equal(getattr(out, name), np.asarray(getattr(ref, name)),
                                          err_msg=f"{name} steps={steps} strength={strength}")


def test_default_edit_runs_three_steps_from_759():
    s = tlcm.make_schedule(tlcm.LCMSchedulerConfig(), 4, strength=0.8)
    assert list(s.timesteps) == [759, 519, 279] and list(s.is_last) == [False, False, True]
    with pytest.raises(ValueError):
        tlcm.make_schedule(tlcm.LCMSchedulerConfig(prediction_type="v_prediction"), 4)


def test_add_noise_and_lcm_step_match_jax():
    rng = np.random.default_rng(0)
    x0, noise, eps, n2 = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32) for _ in range(4))
    cfg = jlcm.LCMSchedulerConfig()
    jsched = jlcm.make_schedule(cfg, 4, strength=0.8)
    tsched = tlcm.make_schedule(tlcm.LCMSchedulerConfig(), 4, strength=0.8)
    ref = jlcm.add_noise(jsched, jnp.asarray(x0), jnp.asarray(noise))
    out = tlcm.add_noise(tsched, torch.from_numpy(x0), torch.from_numpy(noise))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    for i in range(tsched.num_steps):  # the last step returns `denoised`
        ref = jlcm.lcm_step(jsched, i, jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(n2))
        out = tlcm.lcm_step(tsched, i, torch.from_numpy(x0), torch.from_numpy(eps),
                            torch.from_numpy(n2))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def _scene(seed, n=48):
    """Blocks and a disc over mild noise: real edges plus hysteresis chains."""
    rng = np.random.default_rng(seed)
    img = rng.integers(90, 130, (n, n, 3)).astype(np.int32)
    img[8:30, 6:20] += 90
    yy, xx = np.mgrid[:n, :n]
    img[(yy - 30) ** 2 + (xx - 32) ** 2 < 100] -= 70
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("low,high", [(100, 200), (50, 120), (200, 100), (20.7, 60.2)])
def test_canny_bit_exact_to_numpy_reference(low, high):
    imgs = np.stack([_scene(s) for s in range(3)])
    out = canny(torch.from_numpy(imgs), low, high).numpy()
    for i in range(len(imgs)):
        np.testing.assert_array_equal(out[i], canny_np(imgs[i], low, high))
    single = canny(torch.from_numpy(imgs[0]), low, high).numpy()
    np.testing.assert_array_equal(single, canny_np(imgs[0], low, high))


def test_canny_random_noise_bit_exact():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (40, 56, 3)).astype(np.uint8)
    np.testing.assert_array_equal(canny(torch.from_numpy(img)).numpy(), canny_np(img))
