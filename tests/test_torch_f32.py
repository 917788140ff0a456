"""The fp32 quality mode's kernels, held on the CPU.

In fp32 every kernel call of the edit goes to the kernel's fp32 instance
(``csrc/conv3x3_tf32x3.cu`` for the stride-1, fused, upsample and stride-2
convs, ``csrc/flash_attention_tf32x3.cu``, the fp32 entries of
``csrc/group_norm.cu``).  This file holds:

* each fp32 schedule (``conv3x3.plan`` at item size 4 for the stride-1 and,
  with ``fused=True``, the fused conv, ``conv3x3.plan_up2`` at item size 4,
  ``flash_attention.plan_f32``, ``fused_groupnorm.plan`` at item size 4) at
  every shape the SSD-1B and SDXL edit paths at 1024² give it: every output
  once, shared memory within the 227 KB a block may use;
* the PyTorch walks of those schedules (``conv3x3_tiled_plain_f32`` and the
  ``*_tiled_plain_f32`` wrappers, ``attention_tiled_plain_f32``,
  ``group_norm_chunked_plain`` on the fp32 plan) against the JAX package's Pallas kernels in interpret mode at fp32,
  on numpy-seeded inputs, with a planted fault of each read against the same
  tolerance;
* the routing: the port's gates do not depend on the dtype, so every call the
  JAX gates send to a kernel at item size 4 reaches that kernel's fp32
  instance; the extra calls are exactly those JAX's tile pickers refuse for
  the TPU's VMEM budget;
* the inventory's fp32 counts against the calls an fp32 editor makes, and the
  wrappers' dtypes.

Tolerance: rtol = atol = 2e-4 at fp32, the repo's golden one.  The kernels
themselves are held against their plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastedit_tpu.ops import conv3x3 as jconv3x3
from fastedit_tpu.ops import conv_fused as jcf
from fastedit_tpu.ops import flags as jflags
from fastedit_tpu.ops import flash_attention as jfa
from fastedit_tpu.ops import fused_groupnorm as jgn

from fastedit_tpu_torch.models import configs as TC
from fastedit_tpu_torch.ops import conv3x3 as k
from fastedit_tpu_torch.ops import conv_fused as cf
from fastedit_tpu_torch.ops import flags as tflags
from fastedit_tpu_torch.ops import flash_attention as fa
from fastedit_tpu_torch.ops import fused_groupnorm as fg
from fastedit_tpu_torch.ops.groupnorm import group_norm_plain
from fastedit_tpu_torch.tools import inventory
from test_torch_fused import (KERNEL_FUNCS, _count_calls, _jax_stage_overrides, _on_tpu,
                              count_prompt_encodes, jax_route, tiny_sites,
                              with_the_encoder_on_the_kernels)
from test_torch_pipeline import _img

TOL = dict(rtol=2e-4, atol=2e-4)  # the repo's golden tolerance, fp32
ORDER_TOL = dict(rtol=1e-5, atol=1e-5)  # a walk against the plain version: order of sums
SMEM_LIMIT = 232_448  # the dynamic shared memory an H100 block may use
F32 = torch.float32


def _main_path_calls():
    """(kernel, shape) -> calls over the SSD-1B and SDXL edit paths at
    1024², batch 1 and 2, both ControlNets, routed for fp32 by the plan and
    with the VAE encoder on the kernels."""
    calls = Counter()
    for unet in (TC.SSD1B_UNET, TC.SDXL_UNET):
        for cn in (TC.SDXL_CONTROLNET_SMALL, TC.SDXL_CONTROLNET_FULL):
            for batch in (1, 2):
                sites = inventory.edit_sites(unet, cn, TC.SDXL_VAE, 1024, batch=batch, steps=3)
                for routed in (sites, with_the_encoder_on_the_kernels(sites)):
                    calls.update(inventory.kernel_calls(routed, dtype=F32))
    return calls


CALLS = _main_path_calls()


def _keys(kernel):
    return sorted({key for (name, key) in CALLS if name == kernel}, key=str)


# "conv" and "fused": the stride-1 3xTF32 plan (``plan`` at item size 4, the
# fused form's with its ready barriers); "up2": ``plan_up2`` at item size 4 (the
# stride-2 conv's fp32 plan is plan_down2 at item size 4: tests/test_torch_tf32x3.py)
CONV_CASES = ([("conv", key[:5], False) for key in _keys("conv3x3_f32")]
              + [("fused", key[:5], False) for key in _keys("conv3x3_fused_f32")]
              + [("up2", key, False) for key in _keys("conv3x3_up2_f32")])


def test_the_fp32_routes_reach_every_kernel():
    names = {name for name, _ in CALLS}
    assert names == set(inventory.F32_KERNELS)
    assert names == {k + inventory.F32_SUFFIX for k in inventory.BF16_KERNELS
                     if k not in inventory.BF16_ONLY}
    assert len(CONV_CASES) >= 40 and {m for m, _, _ in CONV_CASES} == {"conv", "fused", "up2"}
    assert _keys("conv3x3_down2_f32")


def _cover(pl, shape, mode):
    """Every output pixel x channel of the call exactly once over the plan's
    blocks (numpy, all blocks at once): no block twice, each block inside
    the output, and the blocks' outputs summing to the output's size (an
    up2 block writes one phase: every other pixel of every other row)."""
    b, h, w, cin, cout = shape
    if mode in ("conv", "fused"):
        tb, y0, x0, n0 = k.tile_at(pl, np.arange(pl.tiles))
        phase = np.zeros_like(tb)
    else:
        tb, y0, x0, n0, phase = pl.tile_at(np.arange(pl.tiles))
    ho, wo = (h // 2, w // 2) if mode == "down2" else (h, w)  # low-res for up2
    rows = np.minimum(ho, y0 + pl.rect[0]) - y0
    cols = np.minimum(wo, x0 + pl.rect[1]) - x0
    chans = np.minimum(cout, n0 + pl.bn) - n0
    assert rows.min() >= 1 and cols.min() >= 1 and chans.min() >= 1 and tb.max() == b - 1
    assert len(set(zip(tb.tolist(), y0.tolist(), x0.tolist(), n0.tolist(),
                       phase.tolist()))) == pl.tiles
    phases = 4 if mode == "up2" else 1
    assert set(phase.tolist()) == set(range(phases))
    assert int((rows * cols * chans).sum()) == phases * b * ho * wo * cout


@pytest.mark.parametrize("mode,shape,asym", CONV_CASES,
                         ids=[f"{m}-{'x'.join(map(str, s))}{'-asym' if a else ''}"
                              for m, s, a in CONV_CASES])
def test_conv_plan_f32_covers_the_call(mode, shape, asym):
    """Every fp32 stride-1, fused and upsample plan at the main path's shapes
    (the 3xTF32 kernel's; their tiles: tests/test_torch_tf32x3.py): chunks of
    32 channels, the channel tile :func:`bn_f32` picks, every output once,
    persistent blocks, shared memory within 227 KB."""
    b, h, w, cin, cout = shape
    if mode == "up2":
        pl = k.plan_up2(b, h, w, cin, cout, itemsize=4)
        smem = k.smem_bytes_conv_f32(pl.bn)
    else:
        pl = k.plan(b, h, w, cin, cout, itemsize=4, fused=mode == "fused")
        smem = k.smem_bytes_conv_f32(pl.bn, mode == "fused")
    assert pl.chunk == 32 and pl.rect == (8, 16) and not asym
    assert pl.bn == k.bn_f32(cout) and pl.tiles_n * pl.bn >= cout > (pl.tiles_n - 1) * pl.bn
    _cover(pl, shape, mode)
    assert pl.grid == min(pl.tiles, k.H100_SMS) and pl.tiles < 2**31
    assert pl.smem_bytes == smem <= SMEM_LIMIT


def test_conv_plan_f32_choices():
    # the stride-1 conv: the 3xTF32 instance's tiles of 80, 64, 48 or 8 channels
    assert k.plan(2, 128, 128, 320, 320, itemsize=4).bn == 80  # 320 = 4 x 80
    assert k.plan(2, 64, 64, 640, 640, itemsize=4).bn == 80
    assert k.plan(2, 32, 32, 1280, 1280, itemsize=4).tiles == 256  # 16 rectangles x 16
    assert k.plan(1, 256, 256, 96, 96, itemsize=4).bn == 48  # 96 = 2 x 48, no column empty
    assert k.plan(1, 1024, 1024, 128, 3, itemsize=4).bn == 8
    assert k.plan(1, 1024, 1024, 128, 128, itemsize=4).tiles == 64 * 128 * 2
    assert k.smem_bytes_conv_f32(80) == 1024 + 3 * 23 * 1024 + 7 * 2 * 80 * 128 + 8 * (6 + 14)
    # the fused form: the VAE decoder's Couts on the 64-wide tile, a ready barrier a halo stage
    assert k.plan(1, 128, 128, 512, 512, itemsize=4, fused=True).bn == 64
    assert k.plan(1, 1024, 1024, 128, 128, itemsize=4, fused=True).tiles == 64 * 128 * 2
    assert k.smem_bytes_conv_f32(64, True) == k.smem_bytes_conv_f32(64) + 8 * 3
    assert k.conv_f32_weight_stages(80, True) == 7 and k.conv_f32_weight_stages(64, True) == 8
    # the upsample form: phases x low-res rectangles x channel tiles, the stride-1 rings
    assert k.plan_up2(2, 32, 32, 1280, 1280, itemsize=4).tiles == 2 * 4 * 2 * 16 * 4
    assert k.plan_up2(1, 512, 512, 256, 256, itemsize=4).tiles == 64 * 32 * 4 * 4
    assert k.plan_up2(1, 8, 8, 64, 3, itemsize=4).bn == 8
    assert k.plan_up2(2, 64, 64, 640, 640, itemsize=4).smem_bytes == k.smem_bytes_conv_f32(80)
    with pytest.raises(ValueError):
        k.plan_up2(1, 8, 8, 64, 64, itemsize=8)


ATTN_KEYS = _keys("flash_attention_d64_f32") + _keys("flash_attention_d512_f32")


@pytest.mark.parametrize("key", ATTN_KEYS, ids=lambda s: "x".join(map(str, s)))
def test_attention_plan_f32_covers_the_call(key):
    b, sq, skv, h, d = key
    pl = fa.plan_f32(b, sq, skv, h, d)
    assert (pl.bq, pl.bkv) == fa.F32_TILES[d] and pl.kv_tiles * pl.bkv == skv
    t = np.arange(pl.tiles)
    tb, th, q0 = pl.tile_at(t)
    assert len(set(zip(tb.tolist(), th.tolist(), q0.tolist()))) == pl.tiles == b * h * sq // pl.bq
    assert q0.max() + pl.bq == sq and tb.max() == b - 1 and th.max() == h - 1
    assert pl.smem_bytes == fa.smem_bytes_f32(d) <= SMEM_LIMIT
    assert pl.grid == min(pl.tiles, fa.H100_SMS)  # persistent blocks


def test_attention_plan_f32_shapes():
    assert {key[4] for key in ATTN_KEYS} == {64, 512}
    big = fa.plan_f32(1, 16384, 16384, 1, 512)  # 3xTF32: 64-row tiles, persistent blocks
    assert (big.tiles, big.grid, big.kv_tiles) == (256, 132, 256)
    assert big.smem_bytes == fa.smem_bytes_f32(512) == 231_088
    # hi and lo of Q, K and V^T; per block P's fragments and rescale factors of 256 KV tiles
    assert big.scratch_floats == 2 * 3 * 16384 * 512 + 132 * 256 * (64 * 64 + 64)
    small = fa.plan_f32(1, 4096, 4096, 8, 64)  # 3xTF32: 128-row tiles, persistent blocks
    assert (small.bq, small.tiles, small.grid, small.kv_tiles) == (128, 256, 132, 64)
    assert small.smem_bytes == fa.smem_bytes_f32(64) == 1024 + 2 * 32768 + 5 * 32768 + 8 * 12
    with pytest.raises(ValueError):
        fa.plan_f32(1, 96, 128, 1, 64)
    with pytest.raises(ValueError):
        fa.plan_f32(1, 192, 128, 1, 64)  # not a multiple of the 128-row tile
    with pytest.raises(ValueError):
        fa.plan_f32(1, 128, 128, 1, 128)


GN_KEYS = sorted({key[:5] for name in ("group_norm_f32", "group_norm_scale_shift_f32")
                  for key in _keys(name)})


@pytest.mark.parametrize("key", GN_KEYS, ids=lambda s: "x".join(map(str, s)))
def test_group_norm_plan_f32_covers_the_call(key):
    n, h, w, c, groups = key
    p = fg.plan(n, h * w, c, groups, itemsize=4)
    p2 = fg.plan(n, h * w, c, groups)
    assert p.itemsize == 4 and p.vecs <= 4 and p.stage_bytes == p.tile_px * c * 4
    assert (p.lanes, p.threads) == (p2.lanes, p2.threads)  # 8 channels a thread either way
    assert p.stages * p.stage_bytes <= fg.RING_BYTES
    assert p.smem_bytes <= fg.SMEM_LIMIT
    spans = p.chunks()
    assert spans[0][0] == 0 and spans[-1][1] == h * w  # every pixel once
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert n * p.nchunk <= k.H100_SMS and p.nchunk % p.cluster == 0  # all resident at once
    if p.route == "resident":  # each chunk held whole
        assert p.max_tiles <= p.stages and p.reread_bytes == 0


def test_group_norm_plan_f32_fits_half_the_pixels():
    """A stage of fp32 pixels holds twice the bytes: the resident route
    takes tensors up to half the pixels of bf16's; past it the chunk's
    first stages are read again."""
    assert fg.plan(2, 32 * 32, 1280, 32, itemsize=4).route == "resident"
    big = fg.plan(1, 128 * 128, 512, 32)
    f32 = fg.plan(1, 128 * 128, 512, 32, itemsize=4)
    assert big.route == "resident" and f32.route == "reread"
    assert 0 < f32.reread_bytes < 128 * 128 * 512 * 4 // 2
    with pytest.raises(ValueError):
        fg.plan(1, 64, 64, 32, itemsize=8)


# ----------------------------------------------- the walks against JAX


def _operands(seed, b, h, w, cin, cout, per_batch_bias=False):
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (r.standard_normal((cout, cin, 3, 3)) / np.sqrt(9 * cin)).astype(np.float32)
    bias = r.standard_normal((b, cout) if per_batch_bias else (cout,)).astype(np.float32)
    pre = (r.uniform(0.5, 1.5, (b, cin)).astype(np.float32),
           r.standard_normal((b, cin)).astype(np.float32))
    skip = r.standard_normal((b, h, w, cout)).astype(np.float32)
    return x, wt, bias, pre, skip


def _hwio(w_oihw):
    return np.transpose(w_oihw, (2, 3, 1, 0))


t = torch.from_numpy
# JAX's kernels take widths that are multiples of 8 only.
JAX_SHAPES = [
    (2, 8, 8, 64, 200),  # two images smaller than a tile, ragged Cout (80-wide tiles)
    (1, 8, 16, 72, 3),  # Cin 72: a last chunk of 8; Cout 3: the 8-wide tile
    (1, 16, 24, 96, 128),  # past one rectangle both ways (64-wide tiles)
]


def _far_outside(fault, ref):
    assert float(np.abs(fault - ref).max()) > 100 * (TOL["atol"] + TOL["rtol"] * float(
        np.abs(ref).max()))


@pytest.mark.parametrize("shape", JAX_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv_walk_f32_matches_jax_conv3x3(shape):
    x, wt, bias, _, _ = _operands(40, *shape)
    assert jconv3x3.supports(x.shape, _hwio(wt).shape, 4)
    with jflags.override(pallas_interpret=True):
        ref = np.asarray(jconv3x3.conv3x3(jnp.asarray(x), jnp.asarray(_hwio(wt)),
                                          bias=jnp.asarray(bias), act="silu"))
    out = k.conv3x3_tiled_plain_f32(t(x), t(wt), t(bias), act="silu")
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    _far_outside(k.conv3x3_tiled_plain_f32(t(x), t(wt), t(bias), act="silu",
                                           chunks_skipped=1).numpy(), ref)


@pytest.mark.parametrize("shape", JAX_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv_walk_f32_matches_jax_conv3x3_fused(shape):
    x, wt, bias, pre, sk = _operands(41, *shape, per_batch_bias=True)
    assert jcf.supports_fused(x.shape, _hwio(wt).shape, 4, True)
    with jflags.override(pallas_interpret=True):
        ref = np.asarray(jcf.conv3x3_fused(jnp.asarray(x), jnp.asarray(_hwio(wt)),
                                           jnp.asarray(bias), tuple(map(jnp.asarray, pre)),
                                           None, jnp.asarray(sk)))
    pre_t = tuple(map(t, pre))
    out = cf.conv3x3_fused_tiled_plain_f32(t(x), t(wt), t(bias), pre_t, skip=t(sk))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    # the padding ring mapped by the prologue too (silu(shift) where zeros belong)
    ring = cf.prologue_plain(torch.nn.functional.pad(t(x), (0, 0, 1, 1, 1, 1)), *pre_t)
    wrong = torch.nn.functional.conv2d(ring.permute(0, 3, 1, 2), t(wt)).permute(0, 2, 3, 1)
    _far_outside((wrong + t(bias)[:, None, None, :] + t(sk)).numpy(), ref)


@pytest.mark.parametrize("shape", [(2, 8, 8, 64, 64), (1, 8, 16, 96, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv_walk_f32_matches_jax_conv3x3_up2(shape):
    x, wt, bias, _, _ = _operands(42, *shape)
    assert jcf.supports_up2(x.shape, _hwio(wt).shape, 4)
    with jflags.override(pallas_interpret=True):
        ref = np.asarray(jcf.conv3x3_up2(jnp.asarray(x), jnp.asarray(_hwio(wt)),
                                         jnp.asarray(bias), "silu"))
    out = cf.conv3x3_up2_tiled_plain_f32(t(x), t(wt), t(bias), "silu")
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    phases = cf.make_phase_kernels(t(wt))
    swapped = phases.clone()
    swapped[1, 1] = phases[1, 1].flip(0)  # one phase's tap rows swapped
    _far_outside(cf.up2_phases_plain(t(x), swapped, t(bias), "silu").numpy(), ref)


@pytest.mark.parametrize("asymmetric", [False, True], ids=["pad11", "pad01"])
@pytest.mark.parametrize("shape", [(2, 16, 16, 64, 64), (1, 16, 48, 96, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv_walk_f32_matches_jax_conv3x3_down2(shape, asymmetric):
    x, wt, bias, _, _ = _operands(43, *shape)
    assert jcf.supports_down2(x.shape, _hwio(wt).shape, 4)
    with jflags.override(pallas_interpret=True):
        ref = np.asarray(jcf.conv3x3_down2(jnp.asarray(x), jnp.asarray(_hwio(wt)),
                                           jnp.asarray(bias), None, asymmetric))
    out = cf.conv3x3_down2_tiled_plain_f32(t(x), t(wt), t(bias), None, asymmetric)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    _far_outside(cf.conv3x3_down2_plain(t(x), t(wt), t(bias), None, not asymmetric).numpy(),
                 ref)


WALK_SHAPES = [  # odd and ragged shapes against the plain versions
    (2, 5, 7, 72, 3),
    (1, 9, 20, 96, 320),
    (1, 17, 33, 64, 16),
]


@pytest.mark.parametrize("shape", WALK_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("mode", ["conv", "fused", "up2", "down2"])
def test_conv_walk_f32_equals_the_plain_versions(shape, mode):
    if mode == "down2":
        shape = (shape[0], 2 * shape[1], 2 * shape[2], *shape[3:])
    x, wt, bias, pre, sk = _operands(44, *shape, per_batch_bias=mode == "fused")
    x, wt, bias, sk, pre = t(x), t(wt), t(bias), t(sk), tuple(map(t, pre))
    if mode == "conv":
        out = k.conv3x3_tiled_plain_f32(x, wt, bias, act="silu")
        ref = k.conv3x3_plain(x, wt, bias, "silu")
    elif mode == "fused":
        out = cf.conv3x3_fused_tiled_plain_f32(x, wt, bias, pre, "silu", sk)
        ref = cf.conv3x3_fused_plain(x, wt, bias, pre, "silu", sk)
    elif mode == "up2":
        out, ref = cf.conv3x3_up2_tiled_plain_f32(x, wt, bias), cf.conv3x3_up2_plain(x, wt, bias)
    else:
        out = cf.conv3x3_down2_tiled_plain_f32(x, wt, bias, asymmetric=True)
        ref = cf.conv3x3_down2_plain(x, wt, bias, asymmetric=True)
    assert out.dtype == F32
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **ORDER_TOL)


def _qkv(seed, b, sq, skv, h, d):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal((b, s, h, d)).astype(np.float32) for s in (sq, skv, skv))


@pytest.mark.parametrize("shape", [(1, 128, 128, 2, 64), (2, 256, 128, 2, 64),
                                   (1, 128, 128, 1, 512), (1, 128, 256, 1, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_attention_walk_f32_matches_jax(shape):
    """D = 64 against JAX's head-packed kernel (which it keeps at item size
    4), D = 512 against its per-head one; a skipped KV tile far outside."""
    b, sq, skv, h, d = shape
    q, kk, v = _qkv(45, *shape)
    assert jfa.supports((b, sq, h, d), skv)
    assert jfa.supports_packed((b, sq, h, d), skv, 4) == (d == 64)
    with jflags.override(pallas_interpret=True):
        ref = np.asarray(jfa.flash_attention(*map(jnp.asarray, (q, kk, v))))
    out = fa.attention_tiled_plain_f32(t(q), t(kk), t(v))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(out.numpy(), fa.attention_plain(t(q), t(kk), t(v)).numpy(),
                               **ORDER_TOL)
    short = fa.attention_tiled_plain_f32(t(q), t(kk), t(v), kv_tiles_skipped=1)
    assert float(np.abs(short.numpy() - ref).max()) > 0.05


@pytest.mark.parametrize("shape,groups,act,offset", [
    ((2, 7, 9, 64), 8, "silu", 0.0),
    ((1, 16, 16, 96), 8, None, 50.0),
    ((2, 32, 32, 128), 32, "silu", 50.0),
])
@pytest.mark.parametrize("sms", [132, 3])
def test_group_norm_walk_f32_matches_jax(shape, groups, act, offset, sms):
    """The fp32 plan's walk (chunk partials merged in the kernel's order)
    against the JAX kernel in interpret mode; a one-pass variance fails the
    tolerance where |mean| >> std."""
    r = np.random.default_rng(sum(shape) + sms)
    x = (r.standard_normal(shape) + offset).astype(np.float32)
    gamma = r.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    beta = r.standard_normal(shape[-1]).astype(np.float32)
    with jflags.override(pallas_interpret=True):
        ref = np.asarray(jgn.fused_group_norm(jnp.asarray(x), jnp.asarray(gamma),
                                              jnp.asarray(beta), groups, 1e-6, act))
    out = fg.group_norm_chunked_plain(t(x), t(gamma), t(beta), groups, 1e-6, act, sms=sms)
    assert out.dtype == F32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    if offset:
        xf = t(x).reshape(shape[0], -1, groups, shape[-1] // groups)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = xf.square().mean(dim=(1, 3), keepdim=True) - mean.square()  # one pass
        y = ((xf - mean) * torch.rsqrt(var + 1e-6)).reshape(shape) * t(gamma) + t(beta)
        y = torch.nn.functional.silu(y) if act else y
        bad = ~np.isclose(y.numpy(), ref, **TOL)
        assert bad.any()


# ----------------------------------------------------------- routing


# Sites whose calls the JAX gates refuse at item size 4 and admit at 2: the
# TPU's VMEM tile budget.  Per SSD-1B edit at 1024² (batch 1, CFG, 3 steps):
# the decoder's resnets 512 -> 256 at 512², 256 -> 128 and 128 -> 128 (two) at
# 1024², whose 8 convs the port runs on K5 (JAX: K1 or XLA), and the UNet's
# up-block resnets whose first conv is (2, 32, 32, 2560 -> 1280) x 6 and (2,
# 64, 64, 1920 -> 640) x 3, which the port runs on K1 (JAX: XLA).
VMEM_REFUSED = {
    ("decode", "resnet", (1, 512, 512, 512, 256, 32, False)): 1,
    ("decode", "resnet", (1, 1024, 1024, 256, 128, 32, False)): 1,
    ("decode", "resnet", (1, 1024, 1024, 128, 128, 32, False)): 2,
    ("denoise", "resnet", (2, 32, 32, 2560, 1280, 32, True)): 6,
    ("denoise", "resnet", (2, 64, 64, 1920, 640, 32, True)): 3,
}


def test_fp32_routes_every_jax_kernel_call_and_only_the_vmem_refusals_more():
    """Over the SSD-1B edit at 1024², site by site: the port's fp32 calls
    equal the JAX package's at item size 2 (the port's gates do not depend on
    the dtype, but the bf16-only cross-attention kernel's, which fp32 calls
    bypass as the JAX package does) and at item size 4 everywhere but the VMEM
    refusals."""
    sites = inventory.edit_sites(TC.SSD1B_UNET, TC.SDXL_CONTROLNET_SMALL, TC.SDXL_VAE, 1024,
                                 batch=1, steps=3)
    jax_calls, refused = Counter(), Counter()
    with _on_tpu():
        for (stage, op, key), count in sites.items():
            if op in ("canny", "ln"):  # the JAX package computes both in XLA: no Pallas call
                continue
            with tflags.stage(stage), jflags.override(**_jax_stage_overrides(stage)):
                j4, j2 = Counter(jax_route(op, key, 4)), Counter(jax_route(op, key, 2))
                port = Counter(c for c in inventory.route(op, key, F32)
                               if not c[0].startswith("group_norm"))
            assert port == j2, (stage, op, key)
            if port != j4:
                refused[(stage, op, key)] += count
            for (name, _), c in j4.items():
                jax_calls[name] += c * count
    assert dict(refused) == VMEM_REFUSED
    # per fp32 edit: JAX at item size 4, then the port (the same gates as bf16)
    assert dict(jax_calls) == {"conv3x3": 141, "flash_attention_d64": 102, "conv3x3_up2": 9,
                               "conv3x3_down2": 13, "conv3x3_fused": 20,
                               "flash_attention_d512": 2}
    f32 = inventory.launches_by_kernel(inventory.kernel_calls(sites, dtype=F32))
    assert {name: n for name, n in f32.items() if n} == {
        "conv3x3_f32": 144, "conv3x3_fused_f32": 28, "conv3x3_up2_f32": 9,
        "conv3x3_down2_f32": 13, "group_norm_f32": 195, "group_norm_scale_shift_f32": 28,
        "flash_attention_d64_f32": 102, "flash_attention_d512_f32": 2,
        "canny_prepare_f32": 1, "layer_norm_f32": 306}
    bf16 = inventory.launches_by_kernel(inventory.kernel_calls(sites))
    assert all(bf16[name] == f32[name + inventory.F32_SUFFIX] for name in inventory.BF16_KERNELS
               if name not in inventory.BF16_ONLY)
    # bf16 only: the UNet's cross-attention to the text tokens, which fp32 and JAX leave to
    # the plain version
    assert bf16["cross_attention"] == 102 and "cross_attention_f32" not in f32


# ------------------------------------------------- the editor and wrappers


def test_inventory_f32_counts_equal_the_fp32_editors_calls(monkeypatch):
    """Each wrapper is called by an fp32 editor (the tiny model, real
    topology) as often as the inventory routes fp32 calls to its fp32
    instance."""
    from fastedit_tpu_torch import FastEditor

    ted = FastEditor("tiny", device="cpu", use_full_precision=True, init_seed=3)
    assert ted.dtype == F32 and all(p.dtype == F32 for p in ted.modules.unet.parameters())
    calls = _count_calls(monkeypatch, KERNEL_FUNCS)
    encodes = count_prompt_encodes(monkeypatch)
    ted.edit(_img(3), "a harbor", seed=2)
    expected = inventory.launches_by_kernel(inventory.kernel_calls(
        tiny_sites(ted._control_res, encodes), dtype=F32))
    suffix = inventory.F32_SUFFIX
    assert {name[:-len(suffix)]: n for name, n in expected.items() if n} == dict(calls)
    assert calls["conv3x3"] and calls["conv3x3_up2"] and calls["group_norm"]
    assert encodes == [2] and calls["layer_norm"]


def test_the_fp32_editor_runs_without_tf32_and_restores_it():
    from fastedit_tpu_torch import FastEditor

    backends = torch.backends
    old = backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32
    ted = FastEditor("tiny", device="cpu", use_full_precision=True)
    seen = []
    real = ted._run_edit_body

    def spy(*args, **kwargs):
        seen.append((backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32))
        return real(*args, **kwargs)

    ted._run_edit_body = spy
    try:
        backends.cuda.matmul.allow_tf32 = backends.cudnn.allow_tf32 = True
        ted.edit(_img(4), "a barn", seed=1)
        assert seen == [(False, False)]
        assert (backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32) == (True, True)
    finally:
        backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32 = old


WRAPPERS = {
    "conv3x3": lambda x, w, g: k.conv3x3(x, w),
    "conv3x3_fused": lambda x, w, g: cf.conv3x3_fused(x, w, prenorm=(g[None], g[None])),
    "conv3x3_up2": lambda x, w, g: cf.conv3x3_up2(x, w),
    "conv3x3_down2": lambda x, w, g: cf.conv3x3_down2(x, w, asymmetric=True),
    "group_norm": lambda x, w, g: fg.fused_group_norm(x, g, g, 32),
    "group_norm_scale_shift": lambda x, w, g: fg.group_norm_scale_shift(x, g, g, 32),
    "flash_attention": lambda x, w, g: fa.flash_attention(*(x.reshape(1, 128, 2, 64),) * 3),
}


def _wrapper_operands(dtype, device="cpu"):
    r = np.random.default_rng(46)
    x = t(r.standard_normal((1, 16, 16, 64)).astype(np.float32)).to(device, dtype)
    w = t((r.standard_normal((64, 64, 3, 3)) / 24).astype(np.float32)).to(device, dtype)
    g = t(r.uniform(0.5, 1.5, 64).astype(np.float32)).to(device)
    return x, w.contiguous(memory_format=torch.channels_last), g


PLAINS = {
    "conv3x3": lambda x, w, g: k.conv3x3_plain(x, w),
    "conv3x3_fused": lambda x, w, g: cf.conv3x3_fused_plain(x, w, prenorm=(g[None], g[None])),
    "conv3x3_up2": lambda x, w, g: cf.conv3x3_up2_plain(x, w),
    "conv3x3_down2": lambda x, w, g: cf.conv3x3_down2_plain(x, w, asymmetric=True),
    "group_norm": lambda x, w, g: group_norm_plain(x, g, g, 32),
    "group_norm_scale_shift": lambda x, w, g: fg.group_norm_scale_shift_plain(x, g, g, 32),
    "flash_attention": lambda x, w, g: fa.attention_plain(*(x.reshape(1, 128, 2, 64),) * 3),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("op", sorted(WRAPPERS))
def test_wrappers_take_both_dtypes_on_the_cpu(op, dtype):
    x, w, g = _wrapper_operands(dtype)
    out, ref = WRAPPERS[op](x, w, g), PLAINS[op](x, w, g)
    for o, r in zip(out if isinstance(out, tuple) else (out,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert torch.equal(o, r) and (o.dtype == dtype or op == "group_norm_scale_shift")


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64], ids=["fp16", "fp64"])
@pytest.mark.parametrize("op", sorted(WRAPPERS))
def test_wrappers_refuse_other_dtypes(op, dtype):
    x, w, g = _wrapper_operands(dtype)
    with pytest.raises(TypeError, match="takes bf16 or fp32"):
        WRAPPERS[op](x, w, g)


@pytest.mark.parametrize("op", sorted(WRAPPERS))
def test_fp32_wrappers_never_take_the_plain_version_off_the_cpu(op):
    """An fp32 tensor off the CPU goes to the fp32 kernel or raises: here
    (meta tensors, no card, no nvcc) it must raise and count nothing."""
    x, w, g = _wrapper_operands(F32, "meta")
    before = inventory.launch_counts()
    with pytest.raises((RuntimeError, ValueError, TypeError)):
        WRAPPERS[op](x, w, g)
    assert inventory.launch_counts() == before


def test_fold_up2_folds_fp32_weights_in_pytorch():
    _, w, _ = _wrapper_operands(F32)
    folded = cf.fold_up2(w)
    assert folded.dtype == F32 and folded.shape == (64, 2, 2, 2, 2, 64)
    assert torch.equal(folded, cf.make_phase_kernels(w).permute(4, 0, 1, 2, 3, 5))
