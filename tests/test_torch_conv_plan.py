"""The stride-1 conv kernel's schedule, held on the CPU.

``ops/conv3x3.plan`` decides, from a call's shape alone, what
``csrc/conv3x3.cu`` runs for ``conv3x3`` and ``conv3x3_fused``: the tile
rectangle, the channel tile (the wgmma N), the grid, the shared memory and
the TMA boxes.  The first half holds the plan at every shape the gate admits
on the SSD-1B and SDXL edit paths at 1024² (batch 1 and 2, default and
opt-in configurations) and on the tiny model's.  The second half holds
``conv3x3_tiled_plain``, a plain PyTorch walk of the same schedule (halo
gathered with zero fill, prologue on in-image elements only, nine shifted
taps per 64-channel chunk, epilogue), against the port's plain versions and
against the JAX package's kernels in interpret mode, on numpy-seeded inputs
in fp32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastedit_tpu.ops import conv3x3 as jconv3x3
from fastedit_tpu.ops import conv_fused as jcf
from fastedit_tpu.ops import flags as jflags

from fastedit_tpu_torch.models import configs as TC
from fastedit_tpu_torch.ops import conv3x3 as k
from fastedit_tpu_torch.ops import conv_fused as cf
from fastedit_tpu_torch.ops import flags as tflags
from fastedit_tpu_torch.tools import inventory

TOL = dict(rtol=2e-4, atol=2e-4)  # the repo's golden tolerance, fp32
# The tiled walk and the plain version differ only in the order of fp32
# sums of O(1) products.
ORDER_TOL = dict(rtol=1e-5, atol=1e-5)


def _stride1_shapes():
    """(B, H, W, Cin, Cout) of every conv3x3 / conv3x3_fused call the
    inventory routes to the kernel."""
    shapes = set()
    models = [(u, c, TC.SDXL_VAE, 1024, None) for u in (TC.SSD1B_UNET, TC.SDXL_UNET)
              for c in (TC.SDXL_CONTROLNET_SMALL, TC.SDXL_CONTROLNET_FULL)]
    models.append((TC.TINY_UNET, TC.TINY_CONTROLNET, TC.TINY_VAE, 64, 64))
    for unet, cn, vae, res, control_res in models:
        for batch in (1, 2):
            sites = inventory.edit_sites(unet, cn, vae, res, batch=batch, steps=3,
                                         control_res=control_res)
            for override in ({}, dict(use_cuda_conv=True)):
                with tflags.override(**override):
                    calls = inventory.kernel_calls(sites)
                shapes.update(key[:5] for (kernel, key) in calls
                              if kernel in ("conv3x3", "conv3x3_fused"))
    return sorted(shapes)


STRIDE1_SHAPES = _stride1_shapes()


def test_inventory_reaches_the_plan():
    assert len(STRIDE1_SHAPES) >= 40
    assert {s[4] for s in STRIDE1_SHAPES} >= {3, 4, 128, 256, 320, 512, 640, 1280}
    assert {s[0] for s in STRIDE1_SHAPES} >= {1, 2, 4}


@pytest.mark.parametrize("shape", STRIDE1_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_the_call(shape):
    b, h, w, cin, cout = shape
    assert k.supports((b, h, w, cin), (cout, cin, 3, 3))
    pl = k.plan(b, h, w, cin, cout)
    rh, rw = pl.rect
    assert pl.bn in k.BN_INSTANCES and rh * rw == 128
    # channel tiles cover Cout, and 160 is taken only where nothing is wasted
    assert pl.tiles_n * pl.bn >= cout > (pl.tiles_n - 1) * pl.bn
    assert pl.bn != 160 or cout % 160 == 0
    assert pl.bn != 8 or cout <= 8
    # the kernel's tile walk: every tile lies in one image, none twice
    t = np.arange(pl.tiles)
    tb, y0, x0, n0 = k.tile_at(pl, t)
    assert tb.min() >= 0 and tb.max() == b - 1
    assert y0.max() < h and x0.max() < w and n0.max() < cout
    assert len({*zip(tb.tolist(), y0.tolist(), x0.tolist(), n0.tolist())}) == pl.tiles
    # the rectangles of one channel tile cover every pixel of every image once
    first = n0 == 0
    rows = np.minimum(h, y0[first] + rh) - y0[first]
    cols = np.minimum(w, x0[first] + rw) - x0[first]
    assert rows.min() >= 1 and cols.min() >= 1
    assert int((rows * cols).sum()) == b * h * w
    assert pl.tiles == b * len(pl.rectangles(h, w)) * pl.tiles_n
    cover = np.zeros((h, w), np.int32)
    for ry, rx in pl.rectangles(h, w):
        cover[ry:ry + rh, rx:rx + rw] += 1
    assert (cover == 1).all()
    # resources
    assert 1 <= pl.grid <= min(pl.tiles, k.H100_SMS)
    assert pl.smem_bytes == k.smem_bytes(pl.bn) <= k.SMEM_LIMIT
    for box in (pl.box_x, pl.box_w):
        assert max(box) <= 256 and box[0] * 2 == 128  # 128-byte inner box: one swizzle row
    assert pl.box_x == (64, rw + 2, rh + 2, 1)  # the halo, one image
    assert pl.box_w == (64, 1, pl.bn)


def test_plan_choices_on_the_unet_shapes():
    """The UNet's three shape classes fill the card without a wasted column."""
    for shape, tiles in (((2, 32, 32, 1280, 1280), 128), ((2, 64, 64, 640, 640), 256),
                         ((2, 128, 128, 320, 320), 512)):
        pl = k.plan(*shape)
        assert (pl.bn, pl.tiles, pl.tiles_n * pl.bn) == (160, tiles, shape[4])
    assert k.plan(1, 1024, 1024, 128, 3).bn == 8
    assert k.plan(2, 128, 128, 320, 4).bn == 8
    assert k.plan(1, 512, 512, 256, 256).bn == 128
    assert k.plan(1, 64, 64, 64, 64, sms=4).grid == 4
    with pytest.raises(ValueError):
        k.plan(1, 0, 8, 64, 64)


def test_prologue_exps_counts_staged_in_image_elements():
    pl = k.plan(1, 16, 32, 64, 256)  # 2 x 2 rectangles, 2 channel tiles
    # rows staged per rectangle row: [0, 9) and [7, 16); columns [0, 17), [15, 32)
    assert pl.prologue_exps(1, 16, 32, 64) == (9 + 9) * (17 + 17) * 64 * 2


# ------------------------------------------------- the schedule, in fp32


def _operands(seed, b, h, w, cin, cout, per_batch_bias=False):
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (r.standard_normal((cout, cin, 3, 3)) / np.sqrt(9 * cin)).astype(np.float32)
    bias = r.standard_normal((b, cout) if per_batch_bias else (cout,)).astype(np.float32)
    pre = (r.uniform(0.5, 1.5, (b, cin)).astype(np.float32),
           r.standard_normal((b, cin)).astype(np.float32))
    skip = r.standard_normal((b, h, w, cout)).astype(np.float32)
    return x, wt, bias, pre, skip


SMALL = [
    (2, 5, 7, 72, 3),  # odd H and W, two images smaller than a tile, Cin 72, Cout 3
    (1, 9, 20, 96, 320),  # H and W past one rectangle, Cin 96, two 160-wide tiles
    (2, 8, 8, 64, 200),  # ragged Cout on the 128-wide tile
    (1, 17, 33, 64, 8),  # one pixel past the rectangle both ways
    (3, 8, 16, 128, 4),  # exactly one rectangle, two Cin chunks, Cout 4
]


@pytest.mark.parametrize("shape", SMALL, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("act", [None, "silu"])
def test_tiled_walk_equals_conv3x3_plain(shape, act):
    x, wt, bias, _, _ = _operands(20, *shape)
    t = torch.from_numpy
    out = k.conv3x3_tiled_plain(t(x), t(wt), t(bias), act=act)
    ref = k.conv3x3_plain(t(x), t(wt), t(bias), act)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **ORDER_TOL)


@pytest.mark.parametrize("shape", SMALL, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("per_batch_bias,skip", [(True, False), (False, True)])
def test_tiled_walk_equals_conv3x3_fused_plain(shape, per_batch_bias, skip):
    x, wt, bias, pre, sk = _operands(21, *shape, per_batch_bias=per_batch_bias)
    t = torch.from_numpy
    pre_t, sk_t = tuple(map(t, pre)), (t(sk) if skip else None)
    out = k.conv3x3_tiled_plain(t(x), t(wt), t(bias), pre_t, "silu", sk_t)
    ref = cf.conv3x3_fused_plain(t(x), t(wt), t(bias), pre_t, "silu", sk_t)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **ORDER_TOL)


def test_tiled_walk_keeps_the_ring_zero_and_the_images_apart():
    """What the two planted faults of ``chip_smoke.py`` look like in the
    walk: a prologue that also maps the padding ring, and a halo row taken
    from the neighbouring image, both move the result far beyond the order
    of the sums."""
    x, wt, bias, pre, _ = _operands(22, 2, 8, 16, 64, 64)
    t = torch.from_numpy
    ref = cf.conv3x3_fused_plain(t(x), t(wt), t(bias), tuple(map(t, pre)))
    shifted = k.conv3x3_tiled_plain(t(x), t(wt), t(bias), tuple(map(t, pre)), halo_batch_shift=1)
    assert float((shifted - ref).abs().max()) > 0.1
    assert torch.equal(shifted[:, 1:], k.conv3x3_tiled_plain(
        t(x), t(wt), t(bias), tuple(map(t, pre)))[:, 1:])  # only the top row reads it
    ring = cf.prologue_plain(torch.nn.functional.pad(t(x), (0, 0, 1, 1, 1, 1)),
                             *map(t, pre))[:, 1:-1, 1:-1]
    assert torch.equal(ring, cf.prologue_plain(t(x), *map(t, pre)))


# JAX's kernels take widths that are multiples of 8 only.
JAX_SHAPES = [
    (2, 8, 8, 64, 200),  # two images smaller than a tile, ragged Cout
    (1, 8, 8, 72, 3),  # Cin 72, Cout 3
    (1, 16, 24, 96, 320),  # past one rectangle both ways, Cin 96, 160-wide tiles
]


def _hwio(w_oihw):
    return np.transpose(w_oihw, (2, 3, 1, 0))


@pytest.mark.parametrize("shape", JAX_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tiled_walk_matches_jax_conv3x3(shape):
    x, wt, bias, _, _ = _operands(23, *shape)
    assert jconv3x3.supports(x.shape, _hwio(wt).shape, 4)
    with jflags.override(pallas_interpret=True):
        ref = jconv3x3.conv3x3(jnp.asarray(x), jnp.asarray(_hwio(wt)), bias=jnp.asarray(bias),
                               act="silu")
    t = torch.from_numpy
    out = k.conv3x3_tiled_plain(t(x), t(wt), t(bias), act="silu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("shape", JAX_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tiled_walk_matches_jax_conv3x3_fused(shape):
    x, wt, bias, pre, sk = _operands(24, *shape, per_batch_bias=True)
    assert jcf.supports_fused(x.shape, _hwio(wt).shape, 4, True)
    with jflags.override(pallas_interpret=True):
        ref = jcf.conv3x3_fused(jnp.asarray(x), jnp.asarray(_hwio(wt)), jnp.asarray(bias),
                                tuple(map(jnp.asarray, pre)), None, jnp.asarray(sk))
    t = torch.from_numpy
    out = k.conv3x3_tiled_plain(t(x), t(wt), t(bias), tuple(map(t, pre)), None, t(sk))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
