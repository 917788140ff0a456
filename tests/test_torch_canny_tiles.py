"""The Canny kernel's decomposition on the CPU (``ops/canny.py``): its
schedule (:func:`canny.plan`), its hysteresis step by step
(:func:`canny.hysteresis_schedule`: the tile-local runs and unions with the
kernel's node ids, the unions across tile edges in the persistent order for a
given grid, a pair skipped as the kernel skips it, the write) and its VAE
table, each held to the references: the flood fill, ``canny_np``, the JAX
package's ``_hysteresis`` and ``canny_jax``, and the plain and JAX prepare's
VAE input.  The kernel itself runs only on the card: ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold it to the plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastedit_tpu.ops.canny import _hysteresis as jax_hysteresis
from fastedit_tpu.ops.canny import canny_jax
from fastedit_tpu_torch.ops import canny
from fastedit_tpu_torch.tools import conformance, inventory

GRIDS = [1, 3, 7]
MASKS = ["serpentine", "zigzag", "random 0.1", "random 0.2", "random 0.3", "random 0.4",
         "random 0.5", "random 0.6"]


def _flood(cls):
    return canny.flood_fill_np(cls == canny.STRONG, cls != 0)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("name", MASKS)
def test_schedule_equals_the_flood_fill_and_the_jax_hysteresis(name, grid):
    cls = dict(conformance.stress_classes(seed=2, size=64))[name]
    got = canny.hysteresis_schedule(cls[None], grid)[0]
    want = _flood(cls)
    np.testing.assert_array_equal(got, want)
    jax_out = jax_hysteresis(jnp.asarray(cls == canny.STRONG), jnp.asarray(cls != 0))
    np.testing.assert_array_equal(got, np.asarray(jax_out))


@pytest.mark.parametrize("grid", GRIDS)
def test_schedule_at_a_ragged_size_and_batch(grid):
    """70 x 45 at batch 3: tiles cut at the right and bottom edges, three
    images whose labels share one array (node ids over the batch)."""
    rng = np.random.default_rng(grid)
    cand = rng.random((3, 45, 70)) < np.array([0.25, 0.45, 0.6])[:, None, None]
    cls = (cand.astype(np.uint8) + (cand & (rng.random(cand.shape) < 0.03))).astype(np.uint8)
    got = canny.hysteresis_schedule(cls, grid)
    for i in range(3):
        np.testing.assert_array_equal(got[i], _flood(cls[i]))


def _image(seed, h=64, w=64):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([xx * 4, yy * 3, (xx + yy) * 2], -1) + rng.integers(-6, 7, (h, w, 3))
    img[20:44, 16:48] += 60
    img[5:15, 40:60] = rng.integers(0, 256, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("low,high", [(100, 200), (20, 60), (200, 100)])
def test_schedule_on_images_equals_canny_np_and_canny_jax(low, high):
    imgs = np.stack([_image(1, 45, 70), _image(2, 45, 70)])
    lo, hi = canny.floor_thresholds(low, high)
    cls = canny.classes_plain(torch.from_numpy(imgs), lo, hi).numpy()
    for grid in GRIDS:
        got = canny.hysteresis_schedule(cls, grid)
        for i, img in enumerate(imgs):
            edges = got[i].astype(np.uint8) * 255
            np.testing.assert_array_equal(edges, canny.canny_np(img, low, high))
            jax_edges = np.asarray(canny_jax(jnp.asarray(img, jnp.float32), low, high))
            np.testing.assert_array_equal(edges, jax_edges)


@pytest.mark.parametrize("b,h,w,slots,grid,per_block", [
    (1, 1024, 1024, 1056, 1024, 1), (1, 1024, 1024, 792, 512, 2), (4, 1024, 1024, 1056, 1024, 4),
    (2, 1024, 1024, 660, 512, 4), (3, 45, 70, 1056, 18, 1), (3, 45, 70, 7, 6, 3),
    (1, 1, 1, 1, 1, 1)])
def test_plan(b, h, w, slots, grid, per_block):
    p = canny.plan(b, h, w, slots)
    assert (p.grid, p.tiles_per_block) == (grid, per_block)
    assert p.ntiles == b * -(-h // 32) * -(-w // 32) and p.grid <= slots
    seen = sorted(t for k in range(p.grid) for t in p.tiles_of(k))
    assert seen == list(range(p.ntiles))  # every tile once
    assert all(len(p.tiles_of(k)) in (per_block, per_block - 1) for k in range(p.grid))
    bi, y0, x0 = p.tile(p.ntiles - 1)
    assert (bi, y0, x0) == (b - 1, (-(-h // 32) - 1) * 32, (-(-w // 32) - 1) * 32)


def test_plan_shared_memory_and_refusals():
    # two staged tiles of 36 rows x 128 bytes and the rows' offsets, gray 36²,
    # magnitude 34², the local labels and class map of 32², the 256-entry
    # table and the two tiles in hand, rounded up to 16 bytes
    assert canny.smem_bytes(2) == 9216 + 144 + 5184 + 4624 + 4096 + 1024 + 512 + 8 + 8 == 24816
    assert canny.smem_bytes(4) == 25328
    assert canny.plan(1, 64, 64, 8, 4).smem_bytes == 25328
    for bad in ((0, 8, 8, 4), (1, 8, 8, 0)):
        with pytest.raises(ValueError):
            canny.plan(*bad)
    with pytest.raises(ValueError):
        canny.plan(1, 8, 8, 4, 3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_vae_table_is_the_plain_and_the_jax_vae_input_of_every_byte(dtype):
    from types import SimpleNamespace

    from fastedit_tpu.pipeline.stages import _prepare_one_fn

    table = canny.vae_table(dtype)
    img = np.arange(256 * 3, dtype=np.int64).reshape(16, 16, 3) // 3  # every byte, three times
    img = img.astype(np.uint8)
    _, vae_in = canny.prepare_plain(torch.from_numpy(img)[None], 100, 200, dtype)
    assert torch.equal(vae_in[0].reshape(-1), table[torch.from_numpy(img).reshape(-1).long()])
    f = torch.arange(256).float()
    assert torch.equal(table, (f / 127.5 - 1.0).to(dtype))
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    mod = SimpleNamespace(unet=SimpleNamespace(dtype=jdtype))
    _, j_vae = _prepare_one_fn(mod, 16)(jnp.asarray(img), 100, 200)
    ref = np.asarray(j_vae.astype(jnp.float32)).reshape(-1)[::3]
    got = table.float().numpy()
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(got, ref)
    else:  # XLA divides by 127.5 as a product with its reciprocal: one fp32 ulp
        assert np.abs(got - ref).max() <= 2.0**-23


def test_the_cpu_wrappers_take_the_plain_versions_and_count_nothing():
    img = torch.from_numpy(np.stack([_image(3), _image(4)]))
    lo, hi = canny.threshold_tensors(60, 140, "cpu")
    before = dict(canny.launches)
    control, vae_in = canny.prepare(img, lo, hi, torch.bfloat16)
    want = canny.prepare_plain(img, lo, hi, torch.bfloat16)
    assert torch.equal(control, want[0]) and torch.equal(vae_in, want[1])
    cls, _ = canny.canny_front(img, lo, hi, torch.float32)
    assert torch.equal(canny.canny_hysteresis(cls, torch.float32),
                       canny.canny_hysteresis_plain(cls, torch.float32))
    assert canny.launches == before
    assert set(canny.launches) == {f"canny_{e}{s}" for e in ("prepare", "front", "hysteresis")
                                   for s in ("", "_f32")}


def test_an_edit_routes_prepare_to_one_kernel():
    assert inventory.route("canny", (2, 1024, 1024)) == [("canny_prepare", (2, 1024, 1024))]
    assert "canny_prepare" in inventory.BF16_KERNELS
    assert not {"canny_front", "canny_hysteresis"} & set(inventory.KERNELS)
