"""The wgmma conv kernel's schedules (stride 1 and stride 2), held on the CPU.

``ops/conv3x3.plan`` decides, from a call's shape alone, what
``csrc/conv3x3.cu`` runs for ``conv3x3`` and ``conv3x3_fused``: the tile
rectangle, the channel tile (the wgmma N), the grid, the shared memory and
the TMA boxes.  The first half holds the plan at every shape the gate admits
on the SSD-1B and SDXL edit paths at 1024² (batch 1 and 2, by the kernel
plan and with the VAE encoder on the kernels) and on the tiny model's.  The second half holds
``conv3x3_tiled_plain``, a plain PyTorch walk of the same schedule (halo
gathered with zero fill, prologue on in-image elements only, nine shifted
taps per 64-channel chunk, epilogue), against the port's plain versions and
against the JAX package's kernels in interpret mode, on numpy-seeded inputs
in fp32.  The last part does the same for the stride-2 form:
``ops/conv3x3.plan_down2`` (output rectangle, channel tile, the windows of the
input's four parity planes a tile stages, both paddings) at every inventory
shape, and ``conv3x3_down2_tiled_plain``, its walk; and for the upsample form:
``ops/conv3x3.plan_up2`` (low-res rectangle x channel tile x phase, the halo
shift of every tap of every phase) and ``conv3x3_up2_tiled_plain``.
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
from fastedit_tpu_torch.tools import inventory
from test_torch_fused import with_the_encoder_on_the_kernels

TOL = dict(rtol=2e-4, atol=2e-4)  # the repo's golden tolerance, fp32
# The tiled walk and the plain version differ only in the order of fp32
# sums of O(1) products.
ORDER_TOL = dict(rtol=1e-5, atol=1e-5)


def _stride1_shapes():
    """(B, H, W, Cin, Cout) of every conv3x3 / conv3x3_fused call the
    inventory routes to the kernel, by the plan and with the VAE encoder on
    the kernels."""
    shapes = set()
    models = [(u, c, TC.SDXL_VAE, 1024, None) for u in (TC.SSD1B_UNET, TC.SDXL_UNET)
              for c in (TC.SDXL_CONTROLNET_SMALL, TC.SDXL_CONTROLNET_FULL)]
    models.append((TC.TINY_UNET, TC.TINY_CONTROLNET, TC.TINY_VAE, 64, 64))
    for unet, cn, vae, res, control_res in models:
        for batch in (1, 2):
            sites = inventory.edit_sites(unet, cn, vae, res, batch=batch, steps=3,
                                         control_res=control_res)
            for routed in (sites, with_the_encoder_on_the_kernels(sites)):
                calls = inventory.kernel_calls(routed)
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


# ------------------------------------------------------------- stride 2


def _down2_shapes():
    """(B, H, W, Cin, Cout, asymmetric) of every conv3x3_down2 call the
    inventory routes to the kernel, by the plan and with the VAE encoder on
    the kernels."""
    shapes = set()
    for unet in (TC.SSD1B_UNET, TC.SDXL_UNET):
        for cn in (TC.SDXL_CONTROLNET_SMALL, TC.SDXL_CONTROLNET_FULL):
            for batch in (1, 2):
                sites = inventory.edit_sites(unet, cn, TC.SDXL_VAE, 1024, batch=batch, steps=3)
                for routed in (sites, with_the_encoder_on_the_kernels(sites)):
                    calls = inventory.kernel_calls(routed)
                    shapes.update(key for (kernel, key) in calls if kernel == "conv3x3_down2")
    return sorted(shapes)


DOWN2_SHAPES = _down2_shapes()


def test_inventory_reaches_the_down2_plan():
    assert (1, 256, 256, 96, 256, False) in DOWN2_SHAPES  # the conditioning tower: Cin 96
    assert (2, 128, 128, 320, 320, False) in DOWN2_SHAPES
    assert (2, 64, 64, 640, 640, False) in DOWN2_SHAPES
    assert {s[5] for s in DOWN2_SHAPES} == {False, True}  # the VAE encoder's (0, 1) padding
    assert len(DOWN2_SHAPES) >= 8


@pytest.mark.parametrize("shape", DOWN2_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_down2_plan_covers_the_call(shape):
    b, h, w, cin, cout, asym = shape
    assert cf.supports_down2((b, h, w, cin), (cout, cin, 3, 3))
    pl = k.plan_down2(b, h, w, cin, cout, asym)
    ho, wo = h // 2, w // 2
    rh, rw = pl.rect
    assert pl.bn in k.DOWN2_BN_INSTANCES and rh * rw == 128
    assert pl.tiles_n * pl.bn >= cout > (pl.tiles_n - 1) * pl.bn
    assert pl.bn not in (160, 80) or cout % pl.bn == 0  # no wasted column
    # the tile walk over the output: every tile in one image, none twice, all covered
    t = np.arange(pl.tiles)
    tb, y0, x0, n0 = k.tile_at(pl, t)
    assert tb.min() >= 0 and tb.max() == b - 1
    assert y0.max() < ho and x0.max() < wo and n0.max() < cout
    assert len({*zip(tb.tolist(), y0.tolist(), x0.tolist(), n0.tolist())}) == pl.tiles
    cover = np.zeros((ho, wo), np.int32)
    for ry, rx in pl.rectangles(ho, wo):
        cover[ry:ry + rh, rx:rx + rw] += 1
    assert (cover == 1).all()
    # a halved channel tile only where the full one leaves half the SMs idle
    full = 160 if cout % 160 == 0 else 128
    assert pl.bn == full or 2 * b * pl.tiles_y * pl.tiles_x * -(-cout // full) <= k.H100_SMS
    # resources
    assert 1 <= pl.grid <= min(pl.tiles, k.H100_SMS)
    assert pl.smem_bytes == k.smem_bytes_down2(pl.bn) <= k.SMEM_LIMIT
    assert pl.box_w == (64, 1, pl.bn)
    # the four windows: each parity once; together the tile's (2 rh + 1) x (2 rw + 1) input
    # window; the plane whose parity equals the padding is the larger one and starts earlier
    assert pl.pad == (0 if asym else 1)
    assert sorted(p[:2] for p in pl.planes) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert sum(p[2] * p[3] for p in pl.planes) == (2 * rh + 1) * (2 * rw + 1)
    for py, px, rows, cols, dy, dx in pl.planes:
        assert (rows, dy) == ((rh + 1, pl.pad) if py == pl.pad else (rh, 0))
        assert (cols, dx) == ((rw + 1, pl.pad) if px == pl.pad else (rw, 0))
        assert max(rows, cols) <= 256
    # every tap reads inside its plane's window: input 2 o + k - pad, per axis
    for kk in range(3):
        parity, shift = pl.tap(kk)
        assert parity == (kk - pl.pad) % 2
        for o0 in (0, 8):
            first = 2 * o0 + kk - pl.pad  # input coordinate read by the tile's first output
            start = o0 - (pl.pad if parity == pl.pad else 0)  # the window's first plane row
            assert first == 2 * (start + shift) + parity


def test_down2_plan_choices_on_the_main_path():
    """The SSD-1B path's three stride-2 shapes fill the card."""
    assert (k.plan_down2(2, 128, 128, 320, 320).bn, k.plan_down2(2, 128, 128, 320, 320).tiles) \
        == (160, 128)
    # 2 x 32 x 32 outputs x 640 channels: 64 tiles of 160 channels, so 128 of 80
    assert (k.plan_down2(2, 64, 64, 640, 640).bn, k.plan_down2(2, 64, 64, 640, 640).tiles) \
        == (80, 128)
    assert k.plan_down2(4, 64, 64, 640, 640).bn == 160  # an edit_batch of two fills it at 160
    assert (k.plan_down2(1, 256, 256, 96, 256).bn, k.plan_down2(1, 256, 256, 96, 256).tiles) \
        == (128, 256)
    assert k.plan_down2(1, 16, 16, 64, 8, True).bn == 64
    assert k.plan_down2(1, 64, 64, 64, 64, sms=4).grid == 4
    assert [k.smem_bytes_down2(bn) for bn in k.DOWN2_BN_INSTANCES] == \
        [179_312, 187_504, 212_080, 228_464]
    for bad in ((1, 7, 8, 64, 64), (1, 8, 0, 64, 64)):
        with pytest.raises(ValueError):
            k.plan_down2(*bad)


DOWN2_SMALL = [
    (2, 18, 34, 96, 72),  # Cin 96 (a chunk runs past Cin), outputs past one rectangle both ways
    (1, 16, 16, 64, 8),  # one image smaller than a tile, Cout 8
    (1, 20, 36, 72, 200),  # Cin 72, ragged Cout on the 64-wide tile
    (3, 16, 32, 128, 3),  # exactly one rectangle each, two Cin chunks, Cout 3
]


@pytest.mark.parametrize("shape", DOWN2_SMALL, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("asymmetric", [False, True])
def test_down2_walk_equals_conv3x3_down2_plain(shape, asymmetric):
    x, wt, bias, _, _ = _operands(25, *shape)
    t = torch.from_numpy
    out = cf.conv3x3_down2_tiled_plain(t(x), t(wt), t(bias), "silu", asymmetric)
    ref = cf.conv3x3_down2_plain(t(x), t(wt), t(bias), "silu", asymmetric)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **ORDER_TOL)
    # the other padding, chip_smoke.py's planted fault, is far outside the order of the sums
    other = cf.conv3x3_down2_tiled_plain(t(x), t(wt), t(bias), "silu", not asymmetric)
    assert float((other - ref).abs().max()) > 0.1


def test_down2_walk_reads_zeros_past_cin():
    """A 64-channel chunk that runs past Cin (Cin 96) must read zeros there:
    the weights' zero fill would hide anything finite, so the planted fault is
    a NaN, as a view whose innermost dimension packs both column parities
    would let the neighbouring pixel's channels in."""
    x, wt, bias, _, _ = _operands(26, 1, 16, 16, 96, 64)
    t = torch.from_numpy
    assert bool(cf.conv3x3_down2_tiled_plain(t(x), t(wt), t(bias)).isfinite().all())
    assert not bool(cf.conv3x3_down2_tiled_plain(
        t(x), t(wt), t(bias), poison_past_cin=True).isfinite().any())
    x64 = _operands(26, 1, 16, 16, 64, 64)
    assert bool(cf.conv3x3_down2_tiled_plain(
        t(x64[0]), t(x64[1]), t(x64[2]), poison_past_cin=True).isfinite().all())


@pytest.mark.parametrize("shape", [(2, 16, 16, 64, 200), (1, 16, 48, 96, 320)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("asymmetric", [False, True])
def test_down2_walk_matches_jax_conv3x3_down2(shape, asymmetric):
    x, wt, bias, _, _ = _operands(27, *shape)
    assert jcf.supports_down2(x.shape, _hwio(wt).shape, 4)
    with jflags.override(pallas_interpret=True):
        ref = jcf.conv3x3_down2(jnp.asarray(x), jnp.asarray(_hwio(wt)), jnp.asarray(bias),
                                None, asymmetric)
    t = torch.from_numpy
    out = cf.conv3x3_down2_tiled_plain(t(x), t(wt), t(bias), None, asymmetric)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# ------------------------------------------------------------- upsample


def _up2_shapes():
    """(B, H, W, Cin, Cout) of every conv3x3_up2 call the inventory routes to
    the kernel: SSD-1B, SDXL and the tiny model, batch 1 and 2."""
    shapes = set()
    models = [(u, TC.SDXL_CONTROLNET_SMALL, TC.SDXL_VAE, 1024, None)
              for u in (TC.SSD1B_UNET, TC.SDXL_UNET)]
    models.append((TC.TINY_UNET, TC.TINY_CONTROLNET, TC.TINY_VAE, 64, 64))
    for unet, cn, vae, res, control_res in models:
        for batch in (1, 2):
            sites = inventory.edit_sites(unet, cn, vae, res, batch=batch, steps=3,
                                         control_res=control_res)
            shapes.update(key for (kernel, key) in inventory.kernel_calls(sites)
                          if kernel == "conv3x3_up2")
    return sorted(shapes)


UP2_SHAPES = _up2_shapes()
# the SSD-1B edit at batch 1: shape -> (channel tile, tiles)
UP2_MAIN_PATH = {
    (2, 32, 32, 1280, 1280): (160, 512), (2, 64, 64, 640, 640): (160, 1024),
    (1, 128, 128, 512, 512): (128, 2048), (1, 256, 256, 512, 512): (128, 8192),
    (1, 512, 512, 256, 256): (128, 16384),
}


def test_inventory_reaches_the_up2_plan():
    assert set(UP2_MAIN_PATH) <= set(UP2_SHAPES)
    assert {s[0] for s in UP2_SHAPES} >= {1, 2, 4}  # guidance doubles the UNet's batch
    assert len(UP2_SHAPES) >= 10


@pytest.mark.parametrize("shape", UP2_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_up2_plan_covers_the_call(shape):
    b, h, w, cin, cout = shape
    pl = k.plan_up2(b, h, w, cin, cout)
    rh, rw = pl.rect
    assert pl.bn in k.UP2_BN_INSTANCES and rh * rw == 128 and pl.phases == 4
    assert pl.tiles_n * pl.bn >= cout > (pl.tiles_n - 1) * pl.bn
    assert pl.bn != 160 or cout % 160 == 0
    assert pl.tiles == b * pl.tiles_y * pl.tiles_x * pl.tiles_n * 4
    # the tile walk: the phase fastest, every (image, rectangle, channel tile, phase) once
    t = np.arange(pl.tiles)
    tb, y0, x0, n0, phase = pl.tile_at(t)
    assert (phase[:8] == [0, 1, 2, 3, 0, 1, 2, 3]).all()
    assert tb.min() == 0 and tb.max() == b - 1
    assert y0.max() < h and x0.max() < w and n0.max() < cout
    assert len({*zip(tb.tolist(), y0.tolist(), x0.tolist(), n0.tolist(),
                     phase.tolist())}) == pl.tiles
    # the four phases of the low-res rectangles cover every output pixel once
    cover = np.zeros((2 * h, 2 * w), np.int32)
    for ry, rx in pl.rectangles(h, w):
        for ph in range(4):
            cover[2 * ry + (ph >> 1):2 * min(h, ry + rh):2,
                  2 * rx + (ph & 1):2 * min(w, rx + rw):2] += 1
    assert (cover == 1).all()
    # resources: the stride-1 kernel's, with 16 folded taps where it has 9
    assert 1 <= pl.grid <= min(pl.tiles, k.H100_SMS)
    assert pl.smem_bytes == k.smem_bytes(pl.bn) <= k.SMEM_LIMIT
    assert pl.box_x == (64, rw + 2, rh + 2, 1) and pl.box_w == (64, 1, pl.bn)
    assert sorted(pl.weight_stage(ph, tap) for ph in range(4) for tap in range(4)) \
        == list(range(16))
    if shape in UP2_MAIN_PATH:
        assert (pl.bn, pl.tiles) == UP2_MAIN_PATH[shape]
        assert pl.tiles / k.H100_SMS >= 3.8  # every call fills the card for rounds


def test_up2_plan_choices():
    assert k.plan_up2(1, 8, 16, 64, 200).bn == 128  # ragged Cout on the 128-wide tile
    assert k.plan_up2(1, 8, 16, 64, 3).tiles == 4  # one rectangle, one channel tile, four phases
    assert k.plan_up2(1, 64, 64, 64, 64, sms=4).grid == 4
    with pytest.raises(ValueError):
        k.plan_up2(1, 8, 0, 64, 64)


def test_up2_shift_table_follows_the_phase_kernels():
    """``make_phase_kernels`` gives K[p, q, a, b] for x[i - 1 + a + p, j - 1 + b
    + q]: in the halo that starts at (y0 - 1, x0 - 1) that pixel is at shift
    (a + p, b + q).  Held numerically too: the table's sum over the padded
    input is the conv of the materialised upsample."""
    pl = k.plan_up2(1, 5, 6, 64, 8)
    for p in (0, 1):
        for q in (0, 1):
            for a in (0, 1):
                for b in (0, 1):
                    assert pl.shifts[2 * p + q][2 * a + b] == (a + p, b + q)
    assert {s for phase in pl.shifts for s in phase} == {(dy, dx) for dy in range(3)
                                                         for dx in range(3)}
    x, wt, _, _, _ = _operands(28, 1, 5, 6, 64, 8)
    t = torch.from_numpy
    phases = cf.make_phase_kernels(t(wt))  # [p, q, a, b, Cout, Cin]
    xp = torch.nn.functional.pad(t(x), (0, 0, 1, 1, 1, 1))[0]  # [H + 2, W + 2, Cin]
    out = torch.zeros((10, 12, 8))
    for ph in range(4):
        for tap, (dy, dx) in enumerate(pl.shifts[ph]):
            out[ph >> 1::2, ph & 1::2] += xp[dy:dy + 5, dx:dx + 6] @ phases[
                ph >> 1, ph & 1, tap >> 1, tap & 1].T
    up = t(x).permute(0, 3, 1, 2).repeat_interleave(2, 2).repeat_interleave(2, 3)
    ref = torch.nn.functional.conv2d(up, t(wt), padding=1)[0].permute(1, 2, 0)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **ORDER_TOL)


UP2_SMALL = [
    (2, 5, 7, 96, 24),  # two images smaller than a rectangle, Cin 96 (a chunk runs past Cin)
    (1, 9, 20, 96, 200),  # past one rectangle both ways, ragged Cout on the 128-wide tile
    (1, 8, 16, 64, 320),  # exactly one rectangle, two 160-wide tiles
    (3, 11, 33, 72, 8),  # Cin 72, one pixel past two rectangles
]


@pytest.mark.parametrize("shape", UP2_SMALL, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("act", [None, "silu"])
def test_up2_walk_equals_conv3x3_up2_plain(shape, act):
    x, wt, bias, _, _ = _operands(29, *shape)
    t = torch.from_numpy
    out = cf.conv3x3_up2_tiled_plain(t(x), t(wt), t(bias), act)
    ref = cf.conv3x3_up2_plain(t(x), t(wt), t(bias), act)
    assert out.shape == (shape[0], 2 * shape[1], 2 * shape[2], shape[4])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **ORDER_TOL)
    # chip_smoke.py's planted fault, one phase's tap rows swapped, is far outside that
    phases = cf.make_phase_kernels(t(wt))
    phases[1, 1] = phases[1, 1].flip(0)
    swapped = cf.up2_phases_plain(t(x), phases, t(bias), act)
    assert float((swapped - ref).abs().max()) > 0.1


@pytest.mark.parametrize("shape", [(1, 10, 20, 96, 200), (2, 4, 6, 72, 16), (1, 8, 24, 128, 320)],
                         ids=lambda s: "x".join(map(str, s)))
def test_up2_walk_matches_jax_conv3x3_up2(shape):
    x, wt, bias, _, _ = _operands(30, *shape)
    assert jcf.supports_up2(x.shape, _hwio(wt).shape, 4)
    with jflags.override(pallas_interpret=True):
        ref = jcf.conv3x3_up2(jnp.asarray(x), jnp.asarray(_hwio(wt)), jnp.asarray(bias), "silu")
    t = torch.from_numpy
    out = cf.conv3x3_up2_tiled_plain(t(x), t(wt), t(bias), "silu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
