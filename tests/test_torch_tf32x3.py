"""The fp32 tensor-core kernels' arithmetic (3xTF32), held on the CPU.

The stride-1, fused, upsample and stride-2 convs and the 64- and 512-dim
attention of the fp32 path take every fp32 product as three TF32 products on
``wgmma`` (``csrc/conv3x3_tf32x3.cu``, ``csrc/flash_attention_tf32x3.cu``).
This file holds:

* the split (``ops/tf32x3.py``): rounding to TF32 (ties away from zero) and
  the tensor cores' truncation, as bit operations on an int32 view, against
  a numpy reference on the integer bits; hi + lo recovering x to 2^-22;
* the gate that ``chip_smoke.py`` applies to the kernels on the card, here on
  their PyTorch emulation: against an fp64 reference, three products stay
  within 8x the plain fp32 version's error, single-pass TF32 (the lo products
  dropped) does not;
* the kernels' schedules: ``plan`` (plain and fused), ``plan_up2`` and
  ``plan_down2`` at item size 4 (chunks of 32 channels; channel tiles of 80,
  64, 48 or 8, and of 80 or 64) at every fp32 main-path shape, within 227 KB
  of shared memory and the register-sized tiles, walked by
  ``conv3x3_tiled_plain_f32`` (with the fused prologue and skip),
  ``conv3x3_up2_tiled_plain_f32`` and ``conv3x3_down2_tiled_plain_f32``
  against the plain versions and the JAX package's convs in interpret mode
  (also at a Cin that is no multiple of 32, at Cout 4, with per-channel scale
  and shift, a per-batch bias and a skip); ``plan_f32`` at D = 64 (128-row tiles, Q resident, the
  order of V^T's keys that P's fragments take) and D = 512 (persistent
  blocks, the scratch's floats), the D = 64 walk against JAX's kernel;
* the conv modules' split weights (of the upsample conv: its fp32 phase
  weights'), made again when the weights change;
* the ``tools/kernel_variants.py`` specs of both libraries, in step with the
  sources.

Tolerances: the gate's 8x (``chip_smoke.py``), and rtol = atol = 2e-4 (the
repo's golden fp32 tolerance) against JAX.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fastedit_tpu.ops import conv_fused as jcf
from fastedit_tpu.ops import flags as jflags

from fastedit_tpu_torch.models import configs as TC
from fastedit_tpu_torch.ops import build
from fastedit_tpu_torch.ops import conv3x3 as k
from fastedit_tpu_torch.ops import conv_fused as cf
from fastedit_tpu_torch.ops import flash_attention as fa
from fastedit_tpu_torch.ops import tf32x3
from fastedit_tpu_torch.tools import inventory
from test_torch_fused import with_the_encoder_on_the_kernels

GATE = 8.0  # chip_smoke.py: a kernel's max |err| vs fp64 within 8x the plain fp32 version's
TOL = dict(rtol=2e-4, atol=2e-4)
ORDER_TOL = dict(rtol=1e-5, atol=1e-5)
SMEM_LIMIT = 232_448


def _bits_reference(x: np.ndarray, rounded: bool) -> np.ndarray:
    """TF32 of fp32 ``x`` on its integer bits: the magnitude plus half of the
    13 dropped bits' weight (round to nearest, ties away from zero) or not
    (truncation), the low 13 bits cleared, the sign kept."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    sign, mag = bits & 0x80000000, bits & 0x7FFFFFFF
    if rounded:
        mag = mag + 0x1000
    return ((sign | (mag & 0xFFFFE000)) & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


def _values(seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    x = (r.standard_normal(4096) * np.exp2(r.integers(-20, 20, 4096))).astype(np.float32)
    # ties: a TF32 value plus exactly half of its last place, both signs
    ties = (1.0 + np.arange(1, 65) * 2.0**-10 + 2.0**-11).astype(np.float32)
    return np.concatenate([x, ties, -ties, [0.0, -0.0, 1.0, 2.0**-126]]).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tf32_rounding_and_truncation_on_the_bits(seed):
    x = _values(seed)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(tf32x3.round_tf32(t).numpy(), _bits_reference(x, True))
    np.testing.assert_array_equal(tf32x3.truncate_tf32(t).numpy(), _bits_reference(x, False))
    hi = tf32x3.round_tf32(t).numpy()
    assert np.all(np.abs(hi.astype(np.float64) - x) <= 2.0**-11 * np.abs(x))
    assert np.all(hi.view(np.uint32) & 0x1FFF == 0)
    ties = x[4096:4096 + 64]  # away from zero: the larger neighbour
    assert np.all(tf32x3.round_tf32(torch.from_numpy(ties)).numpy() > ties)


@pytest.mark.parametrize("seed", [0, 1])
def test_split_recovers_x_to_2_pow_22(seed):
    x = _values(seed)
    hi, lo = (a.numpy() for a in tf32x3.split_tf32(torch.from_numpy(x)))
    assert np.all(hi.view(np.uint32) & 0x1FFF == 0) and np.all(lo.view(np.uint32) & 0x1FFF == 0)
    rest = np.abs(x.astype(np.float64) - hi - lo)
    assert np.all(rest <= 2.0**-22 * np.abs(x.astype(np.float64)))
    assert np.all(np.abs(lo) <= 2.0**-11 * np.abs(x.astype(np.float64)))


def _err(out, ref) -> float:
    return float((out.double() - ref).abs().max())


@pytest.mark.parametrize("shape", [(1, 16, 16, 64, 32, False), (2, 16, 32, 96, 64, True),
                                   (1, 32, 32, 128, 64, False)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv_three_products_pass_the_fp64_gate_one_does_not(shape):
    b, h, w, cin, cout, asym = shape
    r = np.random.default_rng(7)
    x = torch.from_numpy(r.standard_normal((b, h, w, cin)).astype(np.float32))
    wt = torch.from_numpy((r.standard_normal((cout, cin, 3, 3)) / np.sqrt(9 * cin))
                          .astype(np.float32))
    bias = torch.from_numpy(r.standard_normal(cout).astype(np.float32) * 0.1)
    pad = (0, 1, 0, 1) if asym else (1, 1, 1, 1)
    ref = F.conv2d(F.pad(x.double().permute(0, 3, 1, 2), pad), wt.double(), stride=2)
    ref = ref.permute(0, 2, 3, 1) + bias.double()
    plain = _err(cf.conv3x3_down2_plain(x, wt, bias, asymmetric=asym), ref)
    three = _err(tf32x3.conv3x3_down2_plain(x, wt, bias, asymmetric=asym), ref)
    one = _err(tf32x3.conv3x3_down2_plain(x, wt, bias, asymmetric=asym, passes=1), ref)
    assert 0 < plain and three <= GATE * plain < one


@pytest.mark.parametrize("shape", [(1, 16, 16, 64, 32), (2, 16, 32, 72, 4), (1, 24, 16, 96, 96)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv_stride1_three_products_pass_the_fp64_gate_one_does_not(shape):
    b, h, w, cin, cout = shape
    x, wt, bias = (torch.from_numpy(a) for a in _operands(9, b, h, w, cin, cout))
    ref = F.conv2d(x.double().permute(0, 3, 1, 2), wt.double(), padding=1)
    ref = ref.permute(0, 2, 3, 1) + bias.double()
    plain = _err(k.conv3x3_plain(x, wt, bias), ref)
    three = _err(tf32x3.conv3x3_plain(x, wt, bias), ref)
    one = _err(tf32x3.conv3x3_plain(x, wt, bias, passes=1), ref)
    assert 0 < plain and three <= GATE * plain < one


@pytest.mark.parametrize("shape", [(1, 16, 16, 64, 32, False, True), (2, 16, 24, 72, 4, True, False),
                                   (1, 24, 16, 128, 64, True, True)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv_fused_three_products_pass_the_fp64_gate_one_does_not(shape):
    """The fused conv's emulation: the prologue in fp32, then the split; per
    channel scale and shift, a per-batch bias, a skip."""
    b, h, w, cin, cout, per_batch_bias, skip = shape
    x, wt, bias = (torch.from_numpy(a) for a in _operands(15, b, h, w, cin, cout))
    r = np.random.default_rng(16)
    if per_batch_bias:
        bias = torch.from_numpy(r.standard_normal((b, cout)).astype(np.float32) * 0.1)
    pre = (torch.from_numpy(r.uniform(0.5, 1.5, (b, cin)).astype(np.float32)),
           torch.from_numpy(r.standard_normal((b, cin)).astype(np.float32) * 0.5))
    sk = torch.from_numpy(r.standard_normal((b, h, w, cout)).astype(np.float32)) if skip else None
    xin = F.silu(x.double() * pre[0].double()[:, None, None, :] + pre[1].double()[:, None, None, :])
    ref = F.conv2d(xin.permute(0, 3, 1, 2), wt.double(), padding=1).permute(0, 2, 3, 1)
    ref = ref + (bias.double()[:, None, None, :] if bias.dim() == 2 else bias.double())
    if sk is not None:
        ref = ref + sk.double()
    plain = _err(cf.conv3x3_fused_plain(x, wt, bias, pre, skip=sk), ref)
    three = _err(tf32x3.conv3x3_fused_plain(x, wt, bias, pre, skip=sk), ref)
    one = _err(tf32x3.conv3x3_fused_plain(x, wt, bias, pre, skip=sk, passes=1), ref)
    assert 0 < plain and three <= GATE * plain < one


@pytest.mark.parametrize("shape", [(1, 8, 8, 64, 32), (2, 8, 12, 72, 4), (1, 12, 8, 96, 80)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv_up2_three_products_pass_the_fp64_gate_one_does_not(shape):
    """The upsample conv's emulation, on the phase weights folded in fp32."""
    b, h, w, cin, cout = shape
    x, wt, bias = (torch.from_numpy(a) for a in _operands(17, b, h, w, cin, cout))
    up = x.double().permute(0, 3, 1, 2).repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    ref = F.conv2d(up, wt.double(), padding=1).permute(0, 2, 3, 1) + bias.double()
    plain = _err(cf.conv3x3_up2_plain(x, wt, bias), ref)
    three = _err(tf32x3.conv3x3_up2_plain(x, wt, bias), ref)
    one = _err(tf32x3.conv3x3_up2_plain(x, wt, bias, passes=1), ref)
    assert 0 < plain and three <= GATE * plain < one


@pytest.mark.parametrize("shape", [(1, 128, 256, 1, 512), (2, 128, 128, 2, 64),
                                   (1, 256, 128, 3, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_attention_three_products_pass_the_fp64_gate_one_does_not(shape):
    b, sq, skv, h, d = shape
    r = np.random.default_rng(8)
    q, kk, v = (torch.from_numpy(r.standard_normal((b, s, h, d)).astype(np.float32))
                for s in (sq, skv, skv))
    qd, kd, vd = (t.double().transpose(1, 2) for t in (q, kk, v))
    ref = (torch.softmax(qd @ kd.transpose(-1, -2) * d**-0.5, -1) @ vd).transpose(1, 2)
    plain = _err(fa.attention_plain(q, kk, v), ref)
    three = _err(tf32x3.attention_plain(q, kk, v), ref)
    one = _err(tf32x3.attention_plain(q, kk, v, passes=1), ref)
    assert 0 < plain and three <= GATE * plain < one


def test_the_split_refuses_what_it_does_not_take():
    with pytest.raises(ValueError):
        tf32x3.conv3x3_down2_plain(torch.zeros(1, 4, 4, 8), torch.zeros(8, 8, 3, 3), passes=2)
    with pytest.raises(TypeError):
        cf.split_tf32(torch.zeros(8, 8, 3, 3, dtype=torch.bfloat16))
    w = torch.randn(8, 8, 3, 3).contiguous(memory_format=torch.channels_last)
    for got, want in zip(cf.split_tf32(w), tf32x3.split_tf32(w), strict=True):
        assert torch.equal(got, want)


def _keys(kernel, controlnets=(TC.SDXL_CONTROLNET_SMALL,)):
    """Every shape key the fp32 kernel ``kernel`` takes on the SSD-1B and SDXL
    edit paths at 1024², batch 1 and 2, by the plan and with the VAE encoder
    on the kernels, with each ControlNet of ``controlnets``."""
    keys = set()
    for unet in (TC.SSD1B_UNET, TC.SDXL_UNET):
        for cn in controlnets:
            for batch in (1, 2):
                sites = inventory.edit_sites(unet, cn, TC.SDXL_VAE, 1024, batch=batch, steps=3)
                for routed in (sites, with_the_encoder_on_the_kernels(sites)):
                    calls = inventory.kernel_calls(routed, dtype=torch.float32)
                    keys |= {key for (name, key) in calls if name == kernel}
    return sorted(keys)


DOWN2_KEYS = _keys("conv3x3_down2_f32")
BOTH_CONTROLNETS = (TC.SDXL_CONTROLNET_SMALL, TC.SDXL_CONTROLNET_FULL)
FUSED_KEYS = _keys("conv3x3_fused_f32", BOTH_CONTROLNETS)
UP2_KEYS = _keys("conv3x3_up2_f32", BOTH_CONTROLNETS)
CONV_KEYS = _keys("conv3x3_f32", BOTH_CONTROLNETS)
D64_KEYS = _keys("flash_attention_d64_f32", BOTH_CONTROLNETS)


@pytest.mark.parametrize("key", DOWN2_KEYS, ids=lambda s: "x".join(map(str, s)))
def test_down2_plan_f32_covers_the_call(key):
    b, h, w, cin, cout, asym = key
    pl = k.plan_down2(b, h, w, cin, cout, asym, itemsize=4)
    assert pl.chunk == 32 and pl.box_w == (32, 1, pl.bn) and pl.pad == (0 if asym else 1)
    assert pl.bn == (80 if cout % 80 == 0 else 64) and pl.tiles_n * pl.bn >= cout
    assert 2 <= pl.weight_stages == k.down2_f32_weight_stages(pl.bn) <= 4
    assert pl.smem_bytes == k.smem_bytes_down2_f32(pl.bn) <= SMEM_LIMIT
    ho, wo = h // 2, w // 2
    rects = pl.rectangles(ho, wo)
    assert len(rects) * b * pl.tiles_n == pl.tiles and pl.grid == min(pl.tiles, k.H100_SMS)
    assert all(y0 < ho and x0 < wo for y0, x0 in rects)
    assert pl.tiles_y * pl.rect[0] >= ho and pl.tiles_x * pl.rect[1] >= wo


def test_down2_plan_f32_main_path_and_smem():
    assert {key[3] % 32 for key in DOWN2_KEYS} == {0}  # every main-path Cin fills its chunks
    assert {key[4] for key in DOWN2_KEYS} >= {256, 320, 640}
    # the shared memory the kernel asks for (conv3x3_down2_tf32x3_geometry mirrors it)
    assert k.smem_bytes_down2_f32(80) == 1024 + 2 * 72_704 + 4 * 2 * 80 * 128 + 8 * (4 + 8)
    assert k.down2_f32_weight_stages(64) == k.down2_f32_weight_stages(80) == 4
    assert k.plan_down2(2, 128, 128, 320, 320, itemsize=4).tiles == 2 * 32 * 4
    with pytest.raises(ValueError):
        k.plan_down2(1, 16, 16, 64, 64, itemsize=8)


def _operands(seed, b, h, w, cin, cout):
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (r.standard_normal((cout, cin, 3, 3)) / np.sqrt(9 * cin)).astype(np.float32)
    return x, wt, (r.standard_normal(cout) * 0.1).astype(np.float32)


@pytest.mark.parametrize("asymmetric", [False, True], ids=["pad11", "pad01"])
@pytest.mark.parametrize("shape", [(1, 16, 32, 72, 80), (2, 16, 16, 104, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_down2_walk_f32_at_a_ragged_cin_matches_jax(shape, asymmetric):
    """Cin 72 and 104 end in a chunk of 8 channels: the walk zero-fills the
    rest of it, as the kernel's loads do, and matches the JAX package's
    stride-2 conv (interpret mode, fp32); a skipped chunk is far outside."""
    x, wt, bias = _operands(11, *shape)
    hwio = np.transpose(wt, (2, 3, 1, 0))
    assert jcf.supports_down2(x.shape, hwio.shape, 4)
    with jflags.override(pallas_interpret=True):
        ref = np.asarray(jcf.conv3x3_down2(jnp.asarray(x), jnp.asarray(hwio),
                                           jnp.asarray(bias), None, asymmetric))
    t = torch.from_numpy
    out = cf.conv3x3_down2_tiled_plain_f32(t(x), t(wt), t(bias), None, asymmetric)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(
        out.numpy(), cf.conv3x3_down2_plain(t(x), t(wt), t(bias), None, asymmetric).numpy(),
        **ORDER_TOL)
    short = cf.conv3x3_down2_tiled_plain_f32(t(x), t(wt), t(bias), None, asymmetric,
                                             chunks_skipped=1)
    assert float(np.abs(short.numpy() - ref).max()) > 100 * 2e-4


def test_attention_plan_f32_d512_scratch_and_grid():
    pl = fa.plan_f32(2, 16384, 16384, 1, 512, sms=132)
    assert (pl.bq, pl.bkv, pl.tiles, pl.grid) == (64, 64, 512, 132)
    assert (pl.panel, pl.stages, pl.v_stages, pl.v_keys) == (32, 3, 3, 32)
    # hi and lo of Q, K and V^T, then per block P's fragments and the rescale factors
    assert pl.scratch_floats == 2 * 2 * (16384 + 2 * 16384) * 512 + 132 * 256 * (4096 + 64)
    small = fa.plan_f32(1, 128, 256, 1, 512, sms=132)
    assert small.grid == small.tiles == 2 and small.kv_tiles == 4
    assert fa.smem_bytes_f32(512) <= SMEM_LIMIT


def _ssd1b_calls(controlnet, kernel):
    """(shape key -> calls) of ``kernel`` per fp32 SSD-1B edit at 1024², batch
    1, CFG, 3 steps run, default configuration."""
    sites = inventory.edit_sites(TC.SSD1B_UNET, controlnet, TC.SDXL_VAE, 1024, batch=1, steps=3)
    return {key: n for (name, key), n in inventory.kernel_calls(sites, dtype=torch.float32).items()
            if name == kernel}


@pytest.mark.parametrize("key", CONV_KEYS, ids=lambda s: "x".join(map(str, s)))
def test_conv_plan_f32_stride1_covers_the_call(key):
    """The stride-1 fp32 plan at every main-path shape: chunks of 32 channels
    in halos of (8 + 2) x (16 + 2) pixels, a register-sized channel tile (the
    tile's accumulators and a tap's fresh ones, 2 x bn / 2, with a tap's 32
    fragment registers within the 168 a thread has: bn <= 80) that leaves the
    fewest columns empty, every rectangle once, shared memory within 227 KB."""
    b, h, w, cin, cout = key
    pl = k.plan(b, h, w, cin, cout, itemsize=4)
    assert pl.chunk == 32 and pl.box_x == (32, 18, 10, 1) and pl.box_w == (32, 1, pl.bn)
    assert pl.bn in k.CONV_F32_BN and 2 * (pl.bn // 2) + 32 <= 168 - 32
    empty = pl.tiles_n * pl.bn - cout
    assert 0 <= empty < pl.bn
    if cout > 8:
        assert empty == min(-(-cout // n) * n - cout for n in (80, 64, 48))
    assert pl.halo_stages == 3 and 7 <= pl.weight_stages == k.conv_f32_weight_stages(pl.bn) <= 8
    assert pl.smem_bytes == k.smem_bytes_conv_f32(pl.bn) <= SMEM_LIMIT
    rects = pl.rectangles(h, w)
    assert len(rects) * b * pl.tiles_n == pl.tiles and pl.grid == min(pl.tiles, k.H100_SMS)
    assert len(set(rects)) == len(rects) and all(y0 < h and x0 < w for y0, x0 in rects)
    assert pl.tiles_y * pl.rect[0] >= h and pl.tiles_x * pl.rect[1] >= w


def test_conv_plan_f32_stride1_main_path():
    """The SSD-1B fp32 edit's stride-1 calls: 144 per edit, 9.829 TFLOP, the
    same with the full ControlNet; Cout 4 and 3 on the 8-wide tile, Cout 96 on
    48 (no column empty), every UNet width on 80; the 32² x 1280 calls are 256
    tiles, 1.94 rounds of 132 blocks."""
    for cn in BOTH_CONTROLNETS:
        calls = _ssd1b_calls(cn, "conv3x3_f32")
        assert sum(calls.values()) == 144
        flops = sum(n * 2 * b * h * w * cout * 9 * cin for (b, h, w, cin, cout), n in calls.items())
        assert round(flops / 1e12, 3) == 9.829
    keys = set(CONV_KEYS)
    assert {(2, 128, 128, 320, 4), (1, 1024, 1024, 128, 3), (1, 256, 256, 96, 96),
            (2, 32, 32, 1280, 1280), (2, 32, 32, 2560, 1280), (2, 64, 64, 1920, 640)} <= keys
    bns = {key: k.plan(*key, itemsize=4).bn for key in keys}
    assert {bn for key, bn in bns.items() if key[4] in (320, 640, 1280)} == {80}
    assert bns[(2, 128, 128, 320, 4)] == bns[(1, 1024, 1024, 128, 3)] == 8
    assert bns[(1, 256, 256, 96, 96)] == 48
    assert k.plan(2, 32, 32, 1280, 1280, itemsize=4).tiles == 256
    assert {key[3] % 32 for key in keys} == {0}  # a ragged last chunk only off the main path
    assert k.conv_f32_weight_stages(80) == 7 and k.conv_f32_weight_stages(64) == 8
    with pytest.raises(ValueError):
        k.plan(1, 16, 16, 64, 64, itemsize=8)


@pytest.mark.parametrize("shape", [(1, 16, 32, 72, 4), (2, 8, 24, 104, 80), (1, 16, 16, 96, 96)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv_walk_f32_stride1_at_a_ragged_cin_matches_jax(shape):
    """Cin 72 and 104 end in a chunk of 8 channels: the walk zero-fills the
    rest of it in both operands, as the kernel's loads do, and matches the
    JAX package's conv (interpret mode, fp32), at Cout 4 (the 8-wide tile) too;
    a skipped chunk is far outside."""
    from fastedit_tpu.ops import conv3x3 as jconv3x3

    x, wt, bias = _operands(12, *shape)
    hwio = np.transpose(wt, (2, 3, 1, 0))
    assert jconv3x3.supports(x.shape, hwio.shape, 4)
    with jflags.override(pallas_interpret=True):
        ref = np.asarray(jconv3x3.conv3x3(jnp.asarray(x), jnp.asarray(hwio),
                                          bias=jnp.asarray(bias), act="silu"))
    t = torch.from_numpy
    out = k.conv3x3_tiled_plain_f32(t(x), t(wt), t(bias), "silu")
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(out.numpy(), k.conv3x3_plain(t(x), t(wt), t(bias), "silu").numpy(),
                               **ORDER_TOL)
    short = k.conv3x3_tiled_plain_f32(t(x), t(wt), t(bias), "silu", chunks_skipped=1)
    assert float(np.abs(short.numpy() - ref).max()) > 100 * 2e-4


FUSED_UP2_CASES = ([("fused", key) for key in FUSED_KEYS]
                   + [("up2", key) for key in UP2_KEYS])


@pytest.mark.parametrize("form,key", FUSED_UP2_CASES,
                         ids=[f"{f}-{'x'.join(map(str, key))}" for f, key in FUSED_UP2_CASES])
def test_conv_plan_f32_fused_and_up2_cover_the_call(form, key):
    """The fused and the upsample fp32 plans at every main-path shape: the
    stride-1 instance's halos of (8 + 2) x (16 + 2) pixels x 32 channels and
    rings (the fused form with a ready barrier per halo stage), a
    register-sized channel tile that leaves the fewest columns empty, every
    (up2: low-res) rectangle once per channel tile (up2: and phase), shared
    memory within 227 KB."""
    b, h, w, cin, cout = key[:5]
    if form == "fused":
        pl = k.plan(b, h, w, cin, cout, itemsize=4, fused=True)
        phases = 1
        assert pl.smem_bytes == k.smem_bytes_conv_f32(pl.bn, True) <= SMEM_LIMIT
        assert pl.weight_stages == k.conv_f32_weight_stages(pl.bn, True)
    else:
        pl = k.plan_up2(b, h, w, cin, cout, itemsize=4)
        phases = pl.phases
        assert pl.smem_bytes == k.smem_bytes_conv_f32(pl.bn) <= SMEM_LIMIT
        assert pl.weight_stages == k.conv_f32_weight_stages(pl.bn)
        assert len({shift for taps in pl.shifts for shift in taps}) == 9  # the halo's nine shifts
    assert pl.chunk == 32 and pl.box_x == (32, 18, 10, 1) and pl.box_w == (32, 1, pl.bn)
    assert pl.bn in k.CONV_F32_BN and 2 * (pl.bn // 2) + 32 <= 168 - 32
    assert pl.bn == k.bn_f32(cout) and 0 <= pl.tiles_n * pl.bn - cout < pl.bn
    assert 7 <= pl.weight_stages <= 8
    rects = pl.rectangles(h, w)
    assert len(set(rects)) == len(rects) and all(y0 < h and x0 < w for y0, x0 in rects)
    assert pl.tiles_y * pl.rect[0] >= h and pl.tiles_x * pl.rect[1] >= w
    assert len(rects) * b * pl.tiles_n * phases == pl.tiles
    assert pl.grid == min(pl.tiles, k.H100_SMS)


def test_conv_plan_f32_fused_and_up2_main_path():
    """The SSD-1B fp32 edit's fused calls: 28 per edit, 6.958 TFLOP, all in
    the VAE decoder (Cout 512, 256, 128: the 64-wide tile); its upsample
    calls: 9, 1.881 TFLOP (16/36 of the materialised conv), the UNet's on the
    80-wide tile, the VAE's on the 64-wide one; the same with the full
    ControlNet."""
    for cn in BOTH_CONTROLNETS:
        fused = _ssd1b_calls(cn, "conv3x3_fused_f32")
        assert sum(fused.values()) == 28
        flops = sum(n * 2 * b * h * w * cout * 9 * cin
                    for (b, h, w, cin, cout, *_), n in fused.items())
        assert round(flops / 1e12, 3) == 6.958
        up2 = _ssd1b_calls(cn, "conv3x3_up2_f32")
        assert sum(up2.values()) == 9
        flops = sum(n * 2 * b * (2 * h) * (2 * w) * cout * 4 * cin
                    for (b, h, w, cin, cout), n in up2.items())
        assert round(flops / 1e12, 3) == 1.881
    assert {k.plan(*key[:5], itemsize=4, fused=True).bn for key in FUSED_KEYS} == {64}
    assert not any(key[5] for key in FUSED_KEYS)  # no per-batch bias on the main path
    assert {key[3] % 32 for key in FUSED_KEYS + UP2_KEYS} == {0}
    assert k.plan_up2(2, 32, 32, 1280, 1280, itemsize=4).tiles == 1024
    assert k.plan_up2(1, 512, 512, 256, 256, itemsize=4).tiles == 32768
    assert k.plan_up2(2, 64, 64, 640, 640, itemsize=4).bn == 80
    assert k.plan_up2(1, 256, 256, 512, 512, itemsize=4).bn == 64


def _prenorm(seed, b, cin, cout, h, w):
    """Per-channel scale and shift (a channel mapped with another's shows), a
    per-batch bias and a skip."""
    r = np.random.default_rng(seed)
    return ((r.uniform(0.5, 1.5, (b, cin)).astype(np.float32),
             r.standard_normal((b, cin)).astype(np.float32)),
            r.standard_normal((b, cout)).astype(np.float32),
            r.standard_normal((b, h, w, cout)).astype(np.float32))


@pytest.mark.parametrize("shape", [(1, 16, 32, 72, 4), (2, 8, 24, 104, 80), (1, 24, 16, 96, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv_walk_f32_fused_at_a_ragged_cin_matches_jax(shape):
    """The fused walk (the prologue on each halo's in-image elements, chunks
    of 32 channels, Cin 72 and 104 ending in a chunk of 8) against the JAX
    package's fused conv in interpret mode at fp32: per-channel scale and
    shift, a per-batch bias, a skip; the padding ring mapped by the prologue
    too, or a skipped chunk, is far outside."""
    b, h, w, cin, cout = shape
    x, wt, _ = _operands(18, *shape)
    pre, bias, sk = _prenorm(19, b, cin, cout, h, w)
    hwio = np.transpose(wt, (2, 3, 1, 0))
    assert jcf.supports_fused(x.shape, hwio.shape, 4, True)
    with jflags.override(pallas_interpret=True):
        ref = np.asarray(jcf.conv3x3_fused(jnp.asarray(x), jnp.asarray(hwio), jnp.asarray(bias),
                                           tuple(map(jnp.asarray, pre)), None, jnp.asarray(sk)))
    t = torch.from_numpy
    pre_t = tuple(map(t, pre))
    out = cf.conv3x3_fused_tiled_plain_f32(t(x), t(wt), t(bias), pre_t, skip=t(sk))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(
        out.numpy(), cf.conv3x3_fused_plain(t(x), t(wt), t(bias), pre_t, skip=t(sk)).numpy(),
        **ORDER_TOL)
    ring = cf.prologue_plain(F.pad(t(x), (0, 0, 1, 1, 1, 1)), *pre_t)
    wrong = F.conv2d(ring.permute(0, 3, 1, 2), t(wt)).permute(0, 2, 3, 1)
    assert float(np.abs((wrong + t(bias)[:, None, None, :] + t(sk)).numpy() - ref).max()) > 0.02
    short = cf.conv3x3_fused_tiled_plain_f32(t(x), t(wt), t(bias), pre_t, skip=t(sk),
                                             chunks_skipped=1)
    assert float(np.abs(short.numpy() - ref).max()) > 100 * 2e-4


@pytest.mark.parametrize("shape", [(1, 8, 16, 72, 4), (2, 8, 8, 104, 80), (1, 12, 20, 64, 96)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv_walk_f32_up2_at_a_ragged_cin_matches_jax(shape):
    """The upsample walk (per low-res rectangle, phase and chunk of 32
    channels, four taps on the halo, the phase weights folded in fp32)
    against the JAX package's upsample conv in interpret mode at fp32; a
    phase with its tap rows swapped, or a skipped chunk, is far outside."""
    x, wt, bias = _operands(20, *shape)
    hwio = np.transpose(wt, (2, 3, 1, 0))
    assert jcf.supports_up2(x.shape, hwio.shape, 4)
    with jflags.override(pallas_interpret=True):
        ref = np.asarray(jcf.conv3x3_up2(jnp.asarray(x), jnp.asarray(hwio), jnp.asarray(bias),
                                         "silu"))
    t = torch.from_numpy
    out = cf.conv3x3_up2_tiled_plain_f32(t(x), t(wt), t(bias), "silu")
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(out.numpy(),
                               cf.conv3x3_up2_plain(t(x), t(wt), t(bias), "silu").numpy(),
                               **ORDER_TOL)
    phases = cf.make_phase_kernels(t(wt))
    phases[1, 1] = phases[1, 1].flip(0).clone()
    swapped = cf.up2_phases_plain(t(x), phases, t(bias), "silu")
    assert float(np.abs(swapped.numpy() - ref).max()) > 100 * 2e-4
    short = cf.conv3x3_up2_tiled_plain_f32(t(x), t(wt), t(bias), "silu", chunks_skipped=1)
    assert float(np.abs(short.numpy() - ref).max()) > 100 * 2e-4


@pytest.mark.parametrize("key", D64_KEYS, ids=lambda s: "x".join(map(str, s)))
def test_attention_plan_f32_d64_keeps_q_resident(key):
    """The D = 64 fp32 plan at every main-path shape: 128-row tiles whose Q in
    hi and lo (64 KB) stays in shared memory beside a ring of five 32 KB K / V
    stages, within 227 KB; persistent blocks; the scratch holds the hi and lo
    copies of Q, K and V^T."""
    b, sq, skv, h, d = key
    pl = fa.plan_f32(b, sq, skv, h, d)
    assert (pl.bq, pl.bkv, pl.stages) == (128, 64, 5) and pl.q_tiles * 128 == sq
    assert pl.smem_bytes == 1024 + 2 * 128 * 64 * 4 + 5 * 2 * 64 * 64 * 4 + 8 * 12 <= SMEM_LIMIT
    assert pl.tiles == b * h * sq // 128 and pl.grid == min(pl.tiles, 132)
    assert pl.scratch_floats == 2 * b * h * (sq + 2 * skv) * 64


def test_attention_plan_f32_d64_main_path():
    """The SSD-1B fp32 edit's 64-dim calls: 102 per edit (2.899 TFLOP) with the
    small ControlNet, 204 (4.896 TFLOP) in quality mode."""
    for cn, calls_edit, tflop in ((TC.SDXL_CONTROLNET_SMALL, 102, 2.899),
                                  (TC.SDXL_CONTROLNET_FULL, 204, 4.896)):
        calls = _ssd1b_calls(cn, "flash_attention_d64_f32")
        assert sum(calls.values()) == calls_edit
        flops = sum(n * 4 * b * h * sq * skv * d for (b, sq, skv, h, d), n in calls.items())
        assert round(flops / 1e12, 3) == tflop
    assert {(2, 1024, 1024, 20, 64), (2, 4096, 4096, 10, 64)} <= set(D64_KEYS)


def test_attention_d64_key_order_is_the_fragment_layout():
    """P's A fragments come straight from S's accumulators: thread t of a
    quad holds S's columns 2 (t % 4) and + 1 of each 8-key k step
    (accumulator layout), and an A fragment at .tf32 takes columns t % 4 and
    t % 4 + 4 of the k step.  So slot t % 4 must hold key 2 (t % 4) and slot
    t % 4 + 4 key 2 (t % 4) + 1, which is the order the prologue writes V^T in;
    a walk in that order equals the plain version."""
    order = fa.plan_f32(1, 128, 128, 1, 64).key_order
    for q in range(4):
        assert (order[q], order[q + 4]) == (2 * q, 2 * q + 1)
    assert fa.plan_f32(1, 128, 128, 1, 512).key_order == tuple(range(8))
    q, kk, v = (torch.from_numpy(a) for a in _qkv(13, 1, 128, 192, 2, 64))
    np.testing.assert_allclose(fa.attention_tiled_plain_f32(q, kk, v).numpy(),
                               fa.attention_plain(q, kk, v).numpy(), **ORDER_TOL)


def _qkv(seed, b, sq, skv, h, d):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal((b, s, h, d)).astype(np.float32) for s in (sq, skv, skv))


@pytest.mark.parametrize("shape", [(2, 128, 256, 3, 64), (1, 256, 128, 2, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_attention_walk_f32_d64_matches_jax(shape):
    """The D = 64 walk (128-row tiles, P V over the keys in the fragments'
    order) against the JAX package's head-packed kernel in interpret mode;
    a skipped KV tile is far outside."""
    from fastedit_tpu.ops import flash_attention as jfa

    q, kk, v = _qkv(14, *shape)
    with jflags.override(pallas_interpret=True):
        ref = np.asarray(jfa.flash_attention(*map(jnp.asarray, (q, kk, v))))
    t = torch.from_numpy
    out = fa.attention_tiled_plain_f32(t(q), t(kk), t(v))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    short = fa.attention_tiled_plain_f32(t(q), t(kk), t(v), kv_tiles_skipped=1)
    assert float(np.abs(short.numpy() - ref).max()) > 0.05


def test_conv3x3_split_is_made_again_after_load_state_dict():
    """``Conv3x3`` keeps the weight's TF32 hi and lo copies (the fp32
    kernel's operands) until the weight changes: the same tensors while it
    stands, new ones after ``load_state_dict`` or an in-place write, each the
    split of the weight it then holds."""
    from fastedit_tpu_torch.models import resnet

    torch.manual_seed(0)
    conv = resnet.Conv3x3(64, 32)
    w = conv.weight.contiguous(memory_format=torch.channels_last)
    first = resnet._tf32_split(conv, w)
    assert resnet._tf32_split(conv, w) is first
    for got, want in zip(first, tf32x3.split_tf32(conv.weight.detach()), strict=True):
        assert torch.equal(got, want)
    conv.load_state_dict({"weight": torch.randn(32, 64, 3, 3), "bias": torch.zeros(32)})
    w = conv.weight.contiguous(memory_format=torch.channels_last)
    second = resnet._tf32_split(conv, w)
    assert second is not first and not torch.equal(second[0], first[0])
    for got, want in zip(second, tf32x3.split_tf32(conv.weight.detach()), strict=True):
        assert torch.equal(got, want)
    with torch.no_grad():
        conv.weight.mul_(2.0)
    assert resnet._tf32_split(conv, w)[0] is not second[0]


def test_conv3x3_up2_split_is_made_again_after_load_state_dict():
    """An upsampler's ``Conv3x3`` keeps the TF32 hi and lo copies of its
    phase weights, folded in fp32 (the fp32 upsample kernel's operands),
    until the weight changes: the same tensors while it stands, new ones after
    ``load_state_dict``, each the split of the fold of the weight it then
    holds."""
    from fastedit_tpu_torch.models import resnet

    torch.manual_seed(1)
    conv = resnet.Conv3x3(64, 32)

    def split():
        w = conv.weight.contiguous(memory_format=torch.channels_last)
        return resnet._prepared(conv, "up2_tf32_split", lambda: cf.split_up2(w))

    def want():  # the fold's sums in the weight's channels_last memory, as the module folds
        w = conv.weight.detach().contiguous(memory_format=torch.channels_last)
        return tf32x3.split_tf32(cf.fold_up2(w))

    first = split()
    assert split() is first and first[0].shape == (32, 2, 2, 2, 2, 64)
    for got, ref in zip(first, want(), strict=True):
        assert torch.equal(got, ref)
    conv.load_state_dict({"weight": torch.randn(32, 64, 3, 3), "bias": torch.zeros(32)})
    second = split()
    assert second is not first and not torch.equal(second[0], first[0])
    for got, ref in zip(second, want(), strict=True):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("spec_name", ["variants_conv_tf32x3.py", "variants_flash_tf32x3.py"])
def test_the_tf32x3_variants_specs_are_in_step(spec_name):
    """Each spec's replacements (the sums in the tensor cores' accumulators and
    single-pass TF32, for every kernel of the library; the conv's halo ring;
    the D = 512 attention's Q split in registers and ring depths) are found in
    its source, and the variants that change the sums or the passes reach
    every kernel: both conv strides share one core, and the attention spec
    changes the D = 64 kernel's helpers and the D = 512 kernel's body."""
    from fastedit_tpu_torch.tools import kernel_variants as kv

    spec: dict = {}
    path = Path(kv.__file__).with_name(spec_name)
    exec(compile(path.read_text(), str(path), "exec"), spec)
    source = (build.CSRC / f"{spec['LIBRARY']}.cu").read_text()
    assert spec["LIBRARY"] in build.KERNELS and spec["VARIANTS"]["as_built"] == []
    assert {"tensor_core_sums", "single_pass"} <= set(spec["VARIANTS"])
    for name, replacements in spec["VARIANTS"].items():
        assert (kv.apply(source, replacements) != source) == bool(replacements), name
    if spec["LIBRARY"] == "flash_attention_tf32x3":  # D = 64's S (helper or call), D = 512's
        for name, d64 in (("tensor_core_sums", "s_panel(part"), ("single_pass", "(d, dql")):
            olds = "".join(old for old, _ in spec["VARIANTS"][name])
            assert d64 in olds and "(s, dql" in olds, name
    else:  # every form shares the core: the sums' variant reaches all four kernels
        for form in ("CONV", "FUSED", "UP2", "DOWN2"):
            assert f"conv_tiles<BN, {form}>" in source
        assert {"prologue_in_registers", "up2_window_at_tap_1"} <= set(spec["VARIANTS"])
