"""The port's CUDA kernels against their plain versions, on a card.

These tests need an NVIDIA card with ``nvcc``; they carry the ``cuda``
marker and skip without a card.  On a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Shapes are small but cover what the main path's shapes exercise: ragged
Cin (72, 96, 320) and Cout (3, 4, 8, 200), the stride-1 kernel's geometry (two
images of several 8 x 16 rectangles, images smaller than one, H and W that
are no multiples of it, all three channel tiles), the SiLU epilogue,
no bias, attention read through strides (q, k, v as slices of one fused
projection), Sq != Skv, a scale that is no power of two, the main path's two
D = 64 shapes and batch 4, and both head dims (D = 512 at the VAE mid block's
shape for one image and two, through strides, with Sq != Skv and a scale of
its own); for the fused resnet, up2 and down2 convs, the prologue, per-batch
bias and skip, the upsample conv's five main-path shapes, both down2 paddings,
Cin 96, all four stride-2 channel tiles and odd-sized inputs; for the GroupNorm kernel and its
statistics launch alone, a large mean offset, 2560 channels (one pixel per block row), schedules
for other SM counts (one chunk through the whole ring, more chunks than a warp merges at once),
the same bits twice and under a CUDA graph's replays; the upsample conv on weights folded once;
the Canny kernel's entries (prepare, the front and the hysteresis) bit for bit against their
plain versions and a flood fill, at sizes that are no multiple of their tile, on the stress
masks of ``tools/conformance.py`` and a 1024² serpentine (with the unions across tile edges
left out, a planted fault, it must break), under a CUDA graph's replays with new thresholds, an
eager prepare with no host sync, and an image off a 16-byte boundary refused.  The
tiny editor's CUDA graphs (``pipeline/graphs.py``) are held against its eager arm bit for bit: at
batch 1 and 2 with and without CFG, replays on new inputs, two keys on one pool in turns, an
asynchronous result past the next replay, and no replay under ``plain_versions``; its prompt graph
against the eager arm bit for bit at 1, 3 and 5 novel prompts, a cached prompt unchanged after a
later replay of the same key, the fp32 editor's prompt graph captured without TF32 while the
process allows it, and one HTTP round trip through ``serve.py`` on the card.  Tolerances are those of ``chip_smoke.py`` (both sides
accumulate in fp32 and round once to bf16; the attention's absolute term
scales with the output's RMS).  The fp32 kernels (the quality mode) are held
the same way at fp32, TF32 off, with ``chip_smoke.py``'s fp32 tolerances:
every conv mode at ragged shapes and each channel tile, attention at both
head dims, GroupNorm and its statistics with a large mean offset, the same
bits twice, and the tiny editor in fp32 on graphs against its eager arm.
The six fp32 kernels on the tensor cores (3xTF32: the stride-1, fused,
upsample and stride-2 convs, the D = 64 and D = 512 attention) are also held
against fp64 within ``chip_smoke.py``'s gate (8x the plain fp32 version's
error, which single-pass TF32 exceeds), at ragged Cin, Cout 3, 4 and 96, the
fused conv's prologue with per-channel scale and shift, per-batch bias and
skip, and through strides; their shared-memory mirrors, the weight split's
bits, a CUDA graph's replays against the eager calls, and the convs' refusal
of an fp32 call without the weight's split.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (ATTN_ABS_OF_RMS, ATTN_REL, CONV_ABS_OF_MAX, CONV_REL, F32_ABS_OF_MAX,
                        F32_ATTN_ABS_OF_RMS, F32_REL, F64_GATE)
from fastedit_tpu_torch.ops import canny as cn
from fastedit_tpu_torch.ops import conv3x3 as k
from fastedit_tpu_torch.ops import conv_fused as cf
from fastedit_tpu_torch.ops import flash_attention as fa
from fastedit_tpu_torch.ops import fused_groupnorm as fg
from fastedit_tpu_torch.ops.groupnorm import group_norm_plain, group_norm_scale_shift_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda on a machine with one")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions are fp32
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _assert_close(out, ref, rel, abs_tol):
    d = (out.float() - ref.float()).abs()
    assert bool(out.float().isfinite().all())
    assert bool((d <= rel * ref.float().abs() + abs_tol).all()), float(d.max())


@pytest.mark.parametrize(
    "n,h,w,cin,cout,act,bias",
    [
        (1, 16, 16, 64, 128, None, True),
        (2, 24, 20, 320, 320, None, True),  # ragged Cin and Cout, odd width
        (1, 32, 32, 128, 3, None, True),  # VAE conv_out tail
        (2, 16, 16, 320, 4, None, False),  # UNet conv_out tail, no bias
        (1, 8, 8, 72, 8, "silu", True),  # Cin not a multiple of 32, SiLU
        (2, 32, 32, 640, 1280, None, True),  # two images of 8 rectangles, 160-wide tiles
        (2, 13, 37, 96, 320, "silu", True),  # H, W not multiples of the rectangle, Cin 96
        (2, 5, 7, 64, 3, None, True),  # two images smaller than one rectangle, Cout 3
        (3, 8, 16, 128, 4, None, False),  # exactly one rectangle each, Cout 4
        (1, 40, 48, 64, 200, None, True),  # ragged Cout on the 128-wide tile
    ],
)
def test_conv3x3_kernel_matches_plain(gen, n, h, w, cin, cout, act, bias):
    x = torch.randn((n, h, w, cin), generator=gen, device="cuda").bfloat16()
    wt = torch.randn((cout, cin, 3, 3), generator=gen, device="cuda") * (9 * cin) ** -0.5
    wt = wt.bfloat16().contiguous(memory_format=torch.channels_last)
    b = torch.randn(cout, generator=gen, device="cuda") if bias else None
    before = k.launches
    out = k.conv3x3(x, wt, b, act)
    ref = k.conv3x3_plain(x, wt, b, act)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    _assert_close(out, ref, CONV_REL, CONV_ABS_OF_MAX * float(ref.float().abs().max()))


@pytest.mark.parametrize(
    "b,sq,skv,h,d",
    [(1, 128, 128, 2, 64), (2, 256, 384, 3, 64), (1, 128, 256, 1, 512), (2, 256, 128, 1, 512)],
)
def test_flash_attention_kernel_matches_plain(gen, b, sq, skv, h, d):
    q = torch.randn((b, sq, h, d), generator=gen, device="cuda").bfloat16()
    kv = torch.randn((b, skv, 2, h, d), generator=gen, device="cuda").bfloat16()
    kk, v = kv[:, :, 0], kv[:, :, 1]  # strided views, as from a fused projection
    before = fa.launches[d]
    out = fa.flash_attention(q, kk, v)
    ref = fa.attention_plain(q, kk, v)
    torch.cuda.synchronize()
    assert fa.launches[d] == before + 1
    rms = float(ref.float().square().mean().sqrt())
    _assert_close(out, ref, ATTN_REL, ATTN_ABS_OF_RMS * rms)


@pytest.mark.parametrize(
    "b,s,h,scale",
    [
        (2, 1024, 20, None),  # the UNet's inner self-attention: 320 tiles, 8 KV tiles each
        (2, 4096, 10, None),  # the outer one: 640 tiles of 32 KV tiles
        (4, 1024, 20, None),  # an edit_batch of two
        (1, 512, 3, 0.3),  # a scale that bf16 rounds: q * bf16(scale) in the kernel
        (4, 4096, 10, None),  # 880 tiles of 192 rows; a head's last tile reaches past Sq
    ],
)
def test_flash_attention_d64_at_the_main_paths_shapes(gen, b, s, h, scale):
    qkv = torch.randn((b, s, 3, h, 64), generator=gen, device="cuda").bfloat16()
    q, kk, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # strided views of one projection
    before = fa.launches[64]
    out = fa.flash_attention(q, kk, v, scale)
    torch.cuda.synchronize()
    assert fa.launches[64] == before + 1
    assert out.is_contiguous() and out.shape == (b, s, h, 64)
    ref = fa.attention_plain(q, kk, v, scale)
    rms = float(ref.float().square().mean().sqrt())
    _assert_close(out, ref, ATTN_REL, ATTN_ABS_OF_RMS * rms)
    # one KV tile of the plan skipped must not pass
    tile = fa.plan_for(q, s).bkv
    short = fa.attention_plain(q, kk[:, :-tile], v[:, :-tile], scale)
    d = (short.float() - ref.float()).abs()
    assert not bool((d <= ATTN_REL * ref.float().abs() + ATTN_ABS_OF_RMS * rms).all())


@pytest.mark.parametrize(
    "b,sq,skv,scale",
    [
        (1, 16384, 16384, None),  # the VAE mid block: 256 tiles of 64 rows, 256 KV tiles each
        (2, 16384, 16384, None),  # an edit_batch of two: 512 tiles, four rounds of the blocks
        # Sq != Skv and a scale of its own, one that bf16 holds: the kernel folds bf16(scale)
        # into q as the TPU kernel does, and a scale that bf16 rounds (0.07 -> 0.0698) moves a
        # softmax this peaked by more than the tolerance's absolute term
        (1, 4096, 1024, 0.09375),
        (2, 128, 8192, None),  # one q tile an image, many KV tiles
    ],
)
def test_flash_attention_d512_at_the_main_paths_shapes(gen, b, sq, skv, scale):
    qkv = torch.randn((b, max(sq, skv), 3, 1, 512), generator=gen, device="cuda").bfloat16()
    q, kk, v = qkv[:, :sq, 0], qkv[:, :skv, 1], qkv[:, :skv, 2]  # strided views
    before = fa.launches[512]
    out = fa.flash_attention(q, kk, v, scale)
    torch.cuda.synchronize()
    assert fa.launches[512] == before + 1
    assert out.is_contiguous() and out.shape == (b, sq, 1, 512)
    ref = fa.attention_plain(q, kk, v, scale)
    rms = float(ref.float().square().mean().sqrt())
    _assert_close(out, ref, ATTN_REL, ATTN_ABS_OF_RMS * rms)
    # one KV tile of the plan (64 keys) skipped must not pass
    tile = fa.plan_for(q, skv).bkv
    assert tile == 64
    short = fa.attention_plain(q, kk[:, :-tile], v[:, :-tile], scale)
    d = (short.float() - ref.float()).abs()
    assert not bool((d <= ATTN_REL * ref.float().abs() + ATTN_ABS_OF_RMS * rms).all())


@pytest.mark.parametrize("d", [64, 512])
def test_flash_attention_gives_the_same_bits_twice(gen, d):
    """No split sums between blocks and no atomics: persistent blocks walk
    their tiles in whatever interleaving, and two launches agree bit for
    bit."""
    b, s, h = (2, 1024, 5) if d == 64 else (2, 8192, 1)  # D = 512: 256 tiles for 132 blocks
    q, kk, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").bfloat16()
                for _ in range(3))
    first, second = fa.flash_attention(q, kk, v), fa.flash_attention(q, kk, v)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _conv_operands(gen, n, h, w, cin, cout):
    x = torch.randn((n, h, w, cin), generator=gen, device="cuda").bfloat16()
    wt = torch.randn((cout, cin, 3, 3), generator=gen, device="cuda") * (9 * cin) ** -0.5
    return x, wt.bfloat16().contiguous(memory_format=torch.channels_last)


def _conv_close(out, ref):
    _assert_close(out, ref, CONV_REL, CONV_ABS_OF_MAX * float(ref.float().abs().max()))


@pytest.mark.parametrize(
    "n,h,w,cin,cout,per_batch_bias,skip,act",
    [
        (2, 16, 16, 64, 128, True, False, None),  # time-embedding bias, two batch items
        (1, 24, 20, 320, 320, False, True, None),  # ragged Cin and Cout, skip
        (2, 8, 8, 72, 8, True, True, "silu"),  # Cin 72, Cout 8, everything at once
        (1, 16, 16, 128, 3, False, False, None),  # Cout 3
        (2, 32, 32, 256, 1280, True, True, None),  # two images of 8 rectangles, 160-wide tiles
        (2, 13, 37, 96, 320, True, True, "silu"),  # H, W not multiples of the rectangle, Cin 96
        (2, 5, 7, 64, 4, False, True, None),  # two images smaller than one rectangle, Cout 4
        (1, 40, 48, 192, 200, False, False, None),  # three Cin chunks, ragged Cout
    ],
)
def test_conv3x3_fused_kernel_matches_plain(gen, n, h, w, cin, cout, per_batch_bias, skip, act):
    x, wt = _conv_operands(gen, n, h, w, cin, cout)
    bias = torch.randn((n, cout) if per_batch_bias else (cout,), generator=gen, device="cuda")
    pre = (torch.rand((n, cin), generator=gen, device="cuda") + 0.5,
           torch.randn((n, cin), generator=gen, device="cuda"))
    sk = torch.randn((n, h, w, cout), generator=gen, device="cuda").bfloat16() if skip else None
    before = cf.launches["conv3x3_fused"]
    out = cf.conv3x3_fused(x, wt, bias, pre, act, sk)
    ref = cf.conv3x3_fused_plain(x, wt, bias, pre, act, sk)
    torch.cuda.synchronize()
    assert cf.launches["conv3x3_fused"] == before + 1
    _conv_close(out, ref)


@pytest.mark.parametrize("fused", [False, True])
def test_stride1_kernels_give_the_same_bits_twice(gen, fused):
    """No atomics and no split sums: the schedule fixes the order of every
    sum, so two launches on the same inputs agree bit for bit (many tiles
    per block, so the blocks walk their tiles in different interleavings)."""
    n, h, w, cin, cout = 2, 96, 80, 320, 320
    x, wt = _conv_operands(gen, n, h, w, cin, cout)
    bias = torch.randn((n, cout) if fused else (cout,), generator=gen, device="cuda")
    if fused:
        pre = (torch.rand((n, cin), generator=gen, device="cuda") + 0.5,
               torch.randn((n, cin), generator=gen, device="cuda"))
        sk = torch.randn((n, h, w, cout), generator=gen, device="cuda").bfloat16()
        run = lambda: cf.conv3x3_fused(x, wt, bias, pre, "silu", sk)  # noqa: E731
    else:
        run = lambda: k.conv3x3(x, wt, bias)  # noqa: E731
    first, second = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_plan_mirrors_the_kernels_shared_memory(gen):
    from fastedit_tpu_torch.ops.build import library

    lib = library("conv3x3")
    for bn in k.BN_INSTANCES:
        assert lib.conv3x3_smem_bytes(bn) == k.smem_bytes(bn) <= k.SMEM_LIMIT
    assert lib.conv3x3_smem_bytes(64) == -1
    for bn in k.DOWN2_BN_INSTANCES:
        assert lib.conv3x3_down2_smem_bytes(bn) == k.smem_bytes_down2(bn) <= k.SMEM_LIMIT
    assert lib.conv3x3_down2_smem_bytes(8) == -1
    for bn in k.UP2_BN_INSTANCES:  # the upsample form runs on the stride-1 rings
        assert lib.conv3x3_up2_smem_bytes(bn) == k.smem_bytes(bn) <= k.SMEM_LIMIT
    assert lib.conv3x3_up2_smem_bytes(8) == -1


def test_attention_plan_mirrors_the_kernels_geometry(gen):
    from fastedit_tpu_torch.ops.build import library

    lib = library("flash_attention")
    for d in fa.HEAD_DIMS:
        bkv, stages = fa.GEOMETRY[d][:2]
        for bq in fa.Q_TILES[d]:
            assert [lib.flash_attention_geometry(d, bq, i) for i in (1, 2, 3, 4, 5)] == \
                [bkv, stages, fa.smem_bytes(d, bq), *fa.V_RING[d]]
            assert fa.smem_bytes(d, bq) <= k.SMEM_LIMIT
    assert lib.flash_attention_geometry(96, 128, 1) == -1
    assert lib.flash_attention_geometry(64, 256, 1) == -1
    assert lib.flash_attention_geometry(512, 32, 1) == -1  # the 32-row kernel is gone


@pytest.mark.parametrize(
    "n,h,w,cin,cout,act",
    [(2, 8, 8, 64, 128, None), (1, 12, 10, 72, 8, "silu"), (1, 16, 16, 320, 3, None)],
)
def test_conv3x3_up2_kernel_matches_plain(gen, n, h, w, cin, cout, act):
    x, wt = _conv_operands(gen, n, h, w, cin, cout)
    bias = torch.randn(cout, generator=gen, device="cuda")
    before = cf.launches["conv3x3_up2"]
    out = cf.conv3x3_up2(x, wt, bias, act)
    ref = cf.conv3x3_up2_plain(x, wt, bias, act)
    torch.cuda.synchronize()
    assert cf.launches["conv3x3_up2"] == before + 1
    assert out.shape == (n, 2 * h, 2 * w, cout)
    _conv_close(out, ref)


@pytest.mark.parametrize(
    "n,h,w,cin,cout,act,bias",
    [
        (2, 32, 32, 1280, 1280, None, True),  # the UNet's two: 512 and 1024 tiles of 160 channels
        (2, 64, 64, 640, 640, None, True),
        (1, 128, 128, 512, 512, None, True),  # the VAE decoder's three, 128-channel tiles
        (1, 256, 256, 512, 512, "silu", True),
        (1, 512, 512, 256, 256, None, False),
        (2, 13, 37, 96, 200, "silu", True),  # ragged H, W, Cin 96 and Cout, SiLU
        (3, 5, 7, 64, 24, None, False),  # images smaller than a rectangle, no bias
    ],
)
def test_conv3x3_up2_at_the_main_paths_shapes(gen, n, h, w, cin, cout, act, bias):
    x, wt = _conv_operands(gen, n, h, w, cin, cout)
    b = torch.randn(cout, generator=gen, device="cuda") if bias else None
    before = cf.launches["conv3x3_up2"]
    out = cf.conv3x3_up2(x, wt, b, act)
    torch.cuda.synchronize()
    assert cf.launches["conv3x3_up2"] == before + 1
    ref = cf.conv3x3_up2_plain(x, wt, b, act)
    _conv_close(out, ref)
    del out
    # one phase's tap rows swapped must not pass
    phases = cf.make_phase_kernels(wt)
    phases[1, 1] = phases[1, 1].flip(0)
    bad = cf.up2_phases_plain(x, phases, b, act)
    d = (bad.float() - ref.float()).abs()
    tol = CONV_REL * ref.float().abs() + CONV_ABS_OF_MAX * float(ref.float().abs().max())
    assert not bool((d <= tol).all())


def test_conv3x3_up2_gives_the_same_bits_twice(gen):
    """A phase's sums are split between no blocks, and the fold of the phase
    weights is a fixed sum: two launches agree bit for bit (31 tiles a
    block)."""
    x, wt = _conv_operands(gen, 2, 96, 80, 320, 320)
    bias = torch.randn(320, generator=gen, device="cuda")
    first, second = cf.conv3x3_up2(x, wt, bias, "silu"), cf.conv3x3_up2(x, wt, bias, "silu")
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("asymmetric", [False, True])
@pytest.mark.parametrize(
    "n,h,w,cin,cout",
    [
        (2, 16, 16, 64, 128),
        (1, 18, 10, 72, 8),
        (1, 32, 32, 96, 3),  # Cin 96: the second chunk runs past Cin
        (2, 36, 40, 96, 200),  # outputs past a rectangle both ways, ragged Cout, BN 64 and 128
        (2, 64, 64, 640, 640),  # a main-path shape: 128 tiles of 80 channels
        (1, 128, 128, 320, 320),  # BN 160
    ],
)
def test_conv3x3_down2_kernel_matches_plain(gen, n, h, w, cin, cout, asymmetric):
    x, wt = _conv_operands(gen, n, h, w, cin, cout)
    bias = torch.randn(cout, generator=gen, device="cuda")
    before = cf.launches["conv3x3_down2"]
    out = cf.conv3x3_down2(x, wt, bias, asymmetric=asymmetric)
    ref = cf.conv3x3_down2_plain(x, wt, bias, asymmetric=asymmetric)
    torch.cuda.synchronize()
    assert cf.launches["conv3x3_down2"] == before + 1
    _conv_close(out, ref)


@pytest.mark.parametrize("asymmetric", [False, True])
def test_conv3x3_down2_gives_the_same_bits_twice(gen, asymmetric):
    """No sum is split between blocks, so two launches agree bit for bit
    (several tiles per block)."""
    x, wt = _conv_operands(gen, 2, 192, 160, 320, 320)
    bias = torch.randn(320, generator=gen, device="cuda")
    first = cf.conv3x3_down2(x, wt, bias, asymmetric=asymmetric)
    second = cf.conv3x3_down2(x, wt, bias, asymmetric=asymmetric)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("asymmetric", [False, True])
def test_conv3x3_down2_keeps_the_images_apart_at_cin_96(gen, asymmetric):
    """Two images, the second all NaN, Cin 96: the first image's result must
    be that of the image alone.  A window of a parity plane that ran past the
    image's last row, or a chunk that ran past Cin at the image's last pixel,
    would read the second image instead of TMA's zero fill."""
    x, wt = _conv_operands(gen, 2, 32, 32, 96, 64)
    x[1] = float("nan")
    out = cf.conv3x3_down2(x, wt, asymmetric=asymmetric)
    ref = cf.conv3x3_down2_plain(x[:1], wt, asymmetric=asymmetric)
    torch.cuda.synchronize()
    _conv_close(out[:1], ref)
    assert bool(out[1].isnan().all())


@pytest.mark.parametrize(
    "shape,groups,act,offset",
    [
        ((2, 16, 16, 320), 32, "silu", 0.0),
        ((1, 24, 24, 128), 32, None, 384.0),  # |mean| >> std
        ((2, 8, 8, 2560), 32, "silu", 0.0),  # two vectors per thread
        ((1, 7, 9, 64), 8, None, 50.0),  # odd pixel count, 8 groups
    ],
)
def test_group_norm_kernel_matches_plain(gen, shape, groups, act, offset):
    x = (torch.randn(shape, generator=gen, device="cuda") * 0.5 + offset).bfloat16()
    gamma = torch.randn(shape[-1], generator=gen, device="cuda") * 0.5 + 1.0
    beta = torch.randn(shape[-1], generator=gen, device="cuda")
    before = fg.launches
    out = fg.fused_group_norm(x, gamma, beta, groups, 1e-5, act)
    ref = group_norm_plain(x, gamma, beta, groups, 1e-5, act)
    torch.cuda.synchronize()
    assert fg.launches == before + 1
    _conv_close(out, ref)


def _gn_operands(gen, shape, offset, dtype=torch.bfloat16):
    x = (torch.randn(shape, generator=gen, device="cuda") * 0.5 + offset).to(dtype)
    gamma = torch.randn(shape[-1], generator=gen, device="cuda") * 0.5 + 1.0
    beta = torch.randn(shape[-1], generator=gen, device="cuda")
    return x, gamma, beta


def _gn_close(out, ref):
    (_f32_close if out.dtype == torch.float32 else _conv_close)(out, ref)


@pytest.mark.parametrize(
    "shape,groups,offset",
    [
        ((1, 16, 16, 256), 32, 0.0),
        ((1, 24, 24, 128), 32, 384.0),  # |mean| >> std
        ((2, 8, 8, 2560), 32, 0.0),  # one pixel per block row
        ((1, 7, 9, 64), 8, 50.0),  # odd pixel count, 8 groups
    ],
)
def test_group_norm_scale_shift_kernel_matches_plain(gen, shape, groups, offset):
    """The statistics launch alone: fp32 (scale, shift) [B, C], one launch
    count per call."""
    x, gamma, beta = _gn_operands(gen, shape, offset)
    before = (fg.launches, fg.scale_shift_launches)
    scale, shift = fg.group_norm_scale_shift(x, gamma, beta, groups, 1e-5)
    rs, rsh = group_norm_scale_shift_plain(x, gamma, beta, groups, 1e-5)
    torch.cuda.synchronize()
    assert (fg.launches, fg.scale_shift_launches) == (before[0], before[1] + 1)
    assert scale.dtype == shift.dtype == torch.float32 and scale.shape == (shape[0], shape[-1])
    _conv_close(scale, rs)
    _conv_close(shift, rsh)


GN_DTYPES = pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                                    ids=["bf16", "fp32"])


@GN_DTYPES
@pytest.mark.parametrize("sms,cluster", [(1, 8), (16, 4), (96, 16), (100, 8)])
def test_group_norm_kernels_at_other_schedules(gen, monkeypatch, sms, cluster, dtype):
    """Plans for other counts of resident blocks and cluster sizes: one block
    per batch item, its chunk through the whole ring and read again, one
    launch per batch item (1); two clusters of four (16); clusters of 16,
    merged over two rounds of a group's lanes (96); six clusters of 8 of the
    50 blocks a batch item may take (100).  Every count stays within what
    the card holds (cooperative launches past it are refused); clusters are
    taken wherever they fit (no cost for them in the plan)."""
    monkeypatch.setattr(fg, "slots_of", lambda t, cluster=8: sms)
    monkeypatch.setattr(fg, "CLUSTER", cluster)
    monkeypatch.setattr(fg, "plan", fg.plan.__wrapped__)  # uncached while patched
    monkeypatch.setattr(fg, "CLUSTER_COST_BYTES", 0)
    x, gamma, beta = _gn_operands(gen, (2, 40, 40, 320), 20.0, dtype)
    p = fg.plan(1 if sms == 1 else 2, 1600, 320, 32, sms, x.element_size(), cluster)
    assert p == (fg.plan_for(x[:1], 32) if sms == 1 else fg.plan_for(x, 32))
    assert p.cluster == {1: 1, 16: 4, 96: 16, 100: 8}[sms]
    assert sms != 1 or (p.nchunk == 1 and p.route == "reread")
    assert sms != 96 or p.cluster > p.merge_lanes
    counts = (fg.launches, fg.launches_f32)
    out = fg.fused_group_norm(x, gamma, beta, 32, 1e-5, "silu")
    scale, shift = fg.group_norm_scale_shift(x, gamma, beta, 32, 1e-5)
    torch.cuda.synchronize()
    per_call = 2 if sms == 1 else 1  # a launch per run of resident batch items
    assert (fg.launches, fg.launches_f32) == (
        (counts[0], counts[1] + per_call) if dtype == torch.float32
        else (counts[0] + per_call, counts[1]))
    _gn_close(out, group_norm_plain(x, gamma, beta, 32, 1e-5, "silu"))
    rs, rsh = group_norm_scale_shift_plain(x, gamma, beta, 32, 1e-5)
    _gn_close(scale, rs)
    _gn_close(shift, rsh)
    if sms != 1:  # the walk of the same schedule
        cs, _ = fg.scale_shift_chunked_plain(x.cpu(), gamma.cpu(), beta.cpu(), 32, 1e-5, sms,
                                             cluster)
        _gn_close(scale.cpu(), cs)


@GN_DTYPES
def test_group_norm_kernels_give_the_same_bits_twice(gen, dtype):
    """Sums in a fixed order, no float atomics: neither the cluster's merge
    nor the batch item's depends on which block finishes first."""
    x, gamma, beta = _gn_operands(gen, (2, 64, 64, 640), 3.0, dtype)
    a = fg.fused_group_norm(x, gamma, beta, 32, 1e-5, "silu")
    b = fg.fused_group_norm(x, gamma, beta, 32, 1e-5, "silu")
    sa = torch.stack(fg.group_norm_scale_shift(x, gamma, beta, 32, 1e-5))
    sb = torch.stack(fg.group_norm_scale_shift(x, gamma, beta, 32, 1e-5))
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(sa, sb)


@GN_DTYPES
@pytest.mark.parametrize("shape", [(2, 32, 32, 1280), (1, 256, 256, 512)],
                         ids=["resident", "reread"])
def test_group_norm_kernels_under_graph_replays(gen, shape, dtype):
    """The kernel sets its counters back to 0, so replays of a captured
    call (a cooperative cluster launch) give the eager call's bits, and each
    call runs one device kernel (GroupNorm, on either route; the
    statistics)."""
    from torch.profiler import ProfilerActivity, profile

    x, gamma, beta = _gn_operands(gen, shape, 1.0, dtype)
    route = fg.plan_for(x, 32).route
    assert route == ("resident" if shape[0] == 2 else "reread")
    eager = fg.fused_group_norm(x, gamma, beta, 32, 1e-5, None)
    eager_ss = torch.stack(fg.group_norm_scale_shift(x, gamma, beta, 32, 1e-5))
    _gn_close(eager, group_norm_plain(x, gamma, beta, 32, 1e-5, None))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = fg.fused_group_norm(x, gamma, beta, 32, 1e-5, None)
            ss = fg.group_norm_scale_shift(x, gamma, beta, 32, 1e-5)
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager) and torch.equal(torch.stack(ss), eager_ss)
    for fn in (lambda: fg.fused_group_norm(x, gamma, beta, 32, 1e-5, None),
               lambda: fg.group_norm_scale_shift(x, gamma, beta, 32, 1e-5)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(names) == 1, names


def test_wrappers_raise_outside_their_contract(gen):
    x = torch.randn((1, 8, 8, 64), generator=gen, device="cuda")
    w = torch.randn((64, 64, 3, 3), generator=gen, device="cuda")
    before = (k.launches, dict(fa.launches))
    with pytest.raises(TypeError):  # fp16: no kernel takes it (fp32 has its own, below)
        k.conv3x3(x.half(), w.half().contiguous(memory_format=torch.channels_last))
    with pytest.raises(ValueError):  # OIHW-contiguous weight
        k.conv3x3(x.bfloat16(), w.bfloat16())
    q = torch.randn((1, 128, 1, 96), generator=gen, device="cuda").bfloat16()
    with pytest.raises(ValueError):  # a head dim the kernel is not built for
        fa.flash_attention(q, q, q)
    xb, wb = x.bfloat16(), w.bfloat16().contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError):  # odd height for the stride-2 kernel
        cf.conv3x3_down2(xb[:, :7], wb)
    with pytest.raises(ValueError):  # attention rows that are no multiple of the tile
        fa.flash_attention(*(torch.zeros((1, 192, 1, 64), device="cuda").bfloat16(),) * 3)
    with pytest.raises(ValueError):  # heads that are not contiguous
        qh = torch.zeros((1, 2, 128, 64), device="cuda").bfloat16().transpose(1, 2)
        fa.flash_attention(qh, qh, qh)
    with pytest.raises(ValueError):  # a scale of the wrong batch
        cf.conv3x3_fused(xb, wb, prenorm=(torch.ones(2, 64, device="cuda"),) * 2)
    with pytest.raises(ValueError):  # channels not divisible by the groups
        fg.fused_group_norm(xb, torch.ones(64, device="cuda"), torch.zeros(64, device="cuda"), 48)
    assert (k.launches, fa.launches) == before


def test_conv3x3_up2_takes_weights_folded_once(gen):
    """``fold_up2`` once, then calls that pass its phases: the bits of a call
    that folds them itself, and the phases equal ``make_phase_kernels``."""
    x = torch.randn((2, 16, 16, 128), generator=gen, device="cuda").bfloat16()
    wt = (torch.randn((128, 128, 3, 3), generator=gen, device="cuda") / 34.0).bfloat16()
    wt = wt.contiguous(memory_format=torch.channels_last)
    bias = torch.randn(128, generator=gen, device="cuda")
    phases = cf.fold_up2(wt)
    ref = cf.make_phase_kernels(wt).permute(4, 0, 1, 2, 3, 5)
    before = cf.launches["conv3x3_up2"]
    a = cf.conv3x3_up2(x, wt, bias, phases=phases)
    b = cf.conv3x3_up2(x, wt, bias)
    torch.cuda.synchronize()
    assert torch.equal(phases, ref) and torch.equal(a, b)
    assert cf.launches["conv3x3_up2"] == before + 2
    with pytest.raises(ValueError):
        cf.conv3x3_up2(x, wt, bias, phases=phases[:64])


# ------------------------------------------------------------ Canny prepare


def _canny_batch(seed, b, h, w):
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 255 // (h + w)], -1)
    img = np.broadcast_to(img, (b, h, w, 3)) + rng.integers(-20, 21, (b, h, w, 3))
    for i in range(b):
        for _ in range(4):
            y0, x0 = rng.integers(0, max(1, h - 8)), rng.integers(0, max(1, w - 8))
            img[i, y0:y0 + rng.integers(4, h // 2 + 5), x0:x0 + rng.integers(4, w // 2 + 5)] = \
                rng.integers(0, 256, 3)
    return torch.from_numpy(np.clip(img, 0, 255).astype(np.uint8)).cuda()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w", [(1, 64, 64), (2, 100, 72), (4, 33, 130), (1, 256, 320),
                                   (3, 45, 70)])
def test_canny_front_matches_plain(gen, b, h, w, dtype):
    """The front entry's class map and VAE input, and the prepare entry's
    control and VAE input, bit for bit, at sizes that are no multiple of the
    32 x 32 tile (rows that start off a 16-byte boundary among them), over
    thresholds with floats, swapped and none at all."""
    img = _canny_batch(b * h + w, b, h, w)
    sfx = "_f32" if dtype == torch.float32 else ""
    for low, high in ((100, 200), (200, 100), (50.7, 120.2), (0, 0), (300, 3000)):
        lo, hi = cn.threshold_tensors(low, high, "cuda")
        before = dict(cn.launches)
        cls, vae_in = cn.canny_front(img, lo, hi, dtype)
        control, vae_prep = cn.prepare(img, lo, hi, dtype)
        cls_p, vae_p = cn.canny_front_plain(img, lo, hi, dtype)
        torch.cuda.synchronize()
        assert {k: v - before[k] for k, v in cn.launches.items() if v != before[k]} == {
            "canny_front" + sfx: 1, "canny_prepare" + sfx: 1}
        assert torch.equal(cls, cls_p), (low, high, int((cls != cls_p).sum()))
        assert torch.equal(vae_in, vae_p) and torch.equal(vae_prep, vae_p)
        assert torch.equal(control, cn.canny_hysteresis_plain(cls_p, dtype))
    # the plain version divides by a device tensor: by a Python number PyTorch
    # multiplies by the reciprocal on the card, which differs in the last bit
    f = img.float()
    assert torch.equal(vae_in, (f / f.new_full((), 127.5) - 1.0).to(dtype))


def test_canny_refuses_an_image_off_a_16_byte_boundary(gen):
    """The kernel stages its rows in 16-byte copies: an image that starts off
    such a boundary is refused before any launch."""
    img = torch.zeros(2 * 64 * 64 * 3 + 1, dtype=torch.uint8, device="cuda")[1:]
    lo, hi = cn.threshold_tensors(100, 200, "cuda")
    before = dict(cn.launches)
    with pytest.raises(ValueError):
        cn.prepare(img.view(2, 64, 64, 3), lo, hi, torch.bfloat16)
    assert cn.launches == before


def _stress(size):
    from fastedit_tpu_torch.tools.conformance import stress_classes

    return stress_classes(seed=size, size=size)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("size", [64, 200])
def test_canny_hysteresis_matches_the_flood_fill(gen, size, dtype):
    """Every stress mask (serpentine, zigzag, random candidates at 0.1 to
    0.6), one batch of all of them, against the flood fill and the plain
    version."""
    import numpy as np

    masks = _stress(size)
    cls = torch.from_numpy(np.stack([m for _, m in masks])).cuda()
    control = cn.canny_hysteresis(cls, dtype)
    plain = cn.canny_hysteresis_plain(cls, dtype)
    torch.cuda.synchronize()
    assert control.dtype == dtype and control.shape == (*cls.shape, 3)
    assert torch.equal(control, plain)
    for i, (name, m) in enumerate(masks):
        want = cn.flood_fill_np(m == cn.STRONG, m != 0)
        assert np.array_equal((control[i, ..., 0] > 0).cpu().numpy(), want), name


def test_canny_hysteresis_on_a_1024_serpentine(gen):
    """~524k pixels in one chain, strong at one end, and the same chain with
    the strong pixel at the far end, against ``scipy.ndimage.label``."""
    import numpy as np
    from scipy import ndimage

    from chip_smoke import canny_with_fault
    from fastedit_tpu_torch.tools.conformance import serpentine

    chain = serpentine(1024, 1024)
    pts = np.argwhere(chain)
    cls = np.stack([chain.astype(np.uint8)] * 2)
    cls[0][tuple(pts[0])] = cls[1][tuple(pts[-1])] = cn.STRONG
    labels, _ = ndimage.label(chain, np.ones((3, 3), bool))
    assert labels.max() == 1
    t = torch.from_numpy(cls).cuda()
    out = cn.canny_hysteresis(t, torch.bfloat16)[..., 0] > 0
    assert torch.equal(out, torch.from_numpy(np.stack([labels == 1] * 2)).cuda())
    # the planted fault: without the unions across tile edges the chain breaks
    bad = canny_with_fault("no_border_unions", "hysteresis", t, torch.bfloat16)[..., 0] > 0
    assert int(bad.sum()) < int(out.sum())


def test_canny_prepare_under_graph_replays_and_without_a_sync(gen):
    """prepare captured once and replayed with new thresholds copied into
    its buffers gives each pair's plain result; an eager call makes no host
    sync."""
    img = _canny_batch(3, 2, 128, 96)
    lo, hi = cn.threshold_tensors(100, 200, "cuda")
    static = (img.clone(), lo.clone(), hi.clone())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cn.prepare(*static, torch.bfloat16)
        cn.threshold_tensors(50, 150, "cuda")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cn.prepare(*static, torch.bfloat16)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        control, vae_in = cn.prepare(*static, torch.bfloat16)
    for low, high in ((100, 200), (50, 150), (200, 100)):
        new_lo, new_hi = cn.threshold_tensors(low, high, "cuda")
        static[1].copy_(new_lo)
        static[2].copy_(new_hi)
        graph.replay()
        want = cn.prepare_plain(img, new_lo, new_hi, torch.bfloat16)
        torch.cuda.synchronize()
        assert torch.equal(control, want[0]) and torch.equal(vae_in, want[1]), (low, high)


# ------------------------------------------------------ the editor's graphs


@pytest.fixture(scope="module")
def tiny_cuda():
    """The tiny editor on the card (bf16), its graphs and its eager arm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda on a machine with one")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from fastedit_tpu_torch import FastEditor

    return FastEditor("tiny")


def _scene(seed, n=64):
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    img = rng.integers(60, 200, (n, n, 3)).astype(np.int32)
    img[10:40, 12:30] += 50
    return Image.fromarray(np.clip(img, 0, 255).astype(np.uint8), "RGB")


def _edit(editor, images, prompts, graphs=True, **kw):
    """(uint8 images, final latents) of one ``edit_batch``."""
    import numpy as np

    from fastedit_tpu_torch.ops import flags

    with flags.override(cuda_graphs=graphs):
        outs = editor.edit_batch(images, prompts, **kw)
    return np.stack([np.asarray(o) for o in outs]), editor.last_latents.clone()


def _assert_same(a, b):
    import numpy as np

    assert np.array_equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("batch,guidance", [(1, 1.5), (1, 1.0), (2, 1.5), (2, 1.0)])
def test_editor_graphs_match_the_eager_arm(tiny_cuda, batch, guidance):
    images = [_scene(s) for s in range(batch)]
    prompts = [f"prompt {s}" for s in range(batch)]
    kw = dict(seed=5, guidance_scale=guidance)
    graph = _edit(tiny_cuda, images, prompts, **kw)  # the key's first call: warm-up, capture
    again = _edit(tiny_cuda, images, prompts, **kw)  # a replay
    eager = _edit(tiny_cuda, images, prompts, graphs=False, **kw)
    _assert_same(graph, eager)
    _assert_same(again, eager)
    assert graph[1].abs().sum() > 0


def test_editor_replay_on_new_inputs_equals_a_fresh_eager_edit(tiny_cuda):
    """Another image, prompt, seed, schedule (5 steps at 0.6: three run, from
    t = 599) and scales, on the key of 4 steps at 0.8."""
    _edit(tiny_cuda, [_scene(0)], ["a"], seed=1)
    keys = len(tiny_cuda._graphs.edit_keys())  # a new prompt may capture a prompt graph
    kw = dict(seed=9, strength=0.6, num_inference_steps=5, guidance_scale=2.5,
              controlnet_conditioning_scale=0.8)
    graph = _edit(tiny_cuda, [_scene(7)], ["a new prompt"], **kw)
    assert len(tiny_cuda._graphs.edit_keys()) == keys
    _assert_same(graph, _edit(tiny_cuda, [_scene(7)], ["a new prompt"], graphs=False, **kw))


def test_editor_replays_one_key_with_new_thresholds(tiny_cuda):
    """Prepare is the chain's first graph: three threshold pairs on one key,
    each equal to a fresh eager edit, and no new capture."""
    _edit(tiny_cuda, [_scene(40)], ["t"], seed=40)
    keys = len(tiny_cuda._graphs.edit_keys())
    for low, high in ((100, 200), (50, 150), (200, 100)):
        kw = dict(seed=41, canny_low_threshold=low, canny_high_threshold=high)
        graph = _edit(tiny_cuda, [_scene(41)], ["t"], **kw)
        _assert_same(graph, _edit(tiny_cuda, [_scene(41)], ["t"], graphs=False, **kw))
    assert len(tiny_cuda._graphs.edit_keys()) == keys


def test_tp_replica_on_one_card_replays_graphs_equal_to_its_eager_arm(tiny_cuda):
    """A tensor-parallel group of one card named twice runs the caller's
    flags and captures its graphs; a replay equals its eager arm bit for
    bit."""
    import numpy as np

    from fastedit_tpu_torch.ops import flags
    from fastedit_tpu_torch.parallel import tp

    group = tiny_cuda.enable_data_parallel(["cuda:0", "cuda:0"], model_parallel=2)
    try:
        replica = group.replicas[0]
        assert any(isinstance(m, tp.TPAttention) for m in replica.modules.unet.modules())
        runs = []
        for graphs in (True, True, False):
            with flags.override(cuda_graphs=graphs):
                outs = tiny_cuda.edit_batch([_scene(50), _scene(51)], ["tp a", "tp b"], seed=50)
            runs.append((np.stack([np.asarray(o) for o in outs]), replica.last_latents.clone()))
        assert len(replica._graphs.edit_keys()) == 1
        _assert_same(runs[0], runs[2])
        _assert_same(runs[1], runs[2])
    finally:
        tiny_cuda._group = None


def test_editor_keys_sharing_one_pool_replay_after_each_other(tiny_cuda):
    a_kw, b_kw = dict(seed=3), dict(seed=4, guidance_scale=1.0)
    runs = []
    for kw, seed in ((a_kw, 10), (b_kw, 11), (a_kw, 12), (b_kw, 13)):
        kw = {**kw, "seed": seed}
        runs.append((_edit(tiny_cuda, [_scene(seed)], ["p"], **kw),
                     _edit(tiny_cuda, [_scene(seed)], ["p"], graphs=False, **kw)))
    for graph, eager in runs:
        _assert_same(graph, eager)
    assert len(tiny_cuda._graphs.captured) >= 2 and tiny_cuda._graphs.pool is not None


def test_edit_batch_async_survives_the_next_replay(tiny_cuda):
    first = tiny_cuda.edit_batch_async([_scene(20)], ["x"], seed=20)
    second = tiny_cuda.edit_batch_async([_scene(21)], ["y"], seed=21)
    a, b = first.result(), second.local_result()
    eager = _edit(tiny_cuda, [_scene(20)], ["x"], graphs=False, seed=20)
    import numpy as np

    assert np.array_equal(np.asarray(a[0]), eager[0][0]) and b[0][0] == 0
    assert not np.array_equal(np.asarray(a[0]), np.asarray(b[0][1]))


def test_plain_versions_never_replay_a_graph(tiny_cuda, monkeypatch):
    from fastedit_tpu_torch.ops import flags
    from fastedit_tpu_torch.pipeline import graphs

    def refuse(*args, **kwargs):
        raise AssertionError("a graph was replayed under plain_versions")

    monkeypatch.setattr(graphs.EditGraphs, "run", refuse)
    with flags.override(plain_versions=True):
        tiny_cuda.edit(_scene(30), "plain", seed=30)
    with pytest.raises(AssertionError):
        tiny_cuda.edit(_scene(30), "graphs", seed=30)


def _encode(editor, prompts, graphs=True):
    """The cached (context, pooled) rows of ``prompts``, encoded anew."""
    from fastedit_tpu_torch.ops import flags

    for p in prompts:
        editor._prompt_cache.pop(p, None)
    with flags.override(cuda_graphs=graphs):
        editor._encode_prompts(prompts)
    return [tuple(t.clone() for t in editor._prompt_cache[p]) for p in prompts]


@pytest.mark.parametrize("novel", [1, 3, 5])
def test_prompt_graph_matches_the_eager_arm(tiny_cuda, novel):
    """One replay of the prompt graph of the padded count (1, 4, 8) against
    the eager arm at the same count, bit for bit."""
    from fastedit_tpu_torch.pipeline import graphs

    prompts = [f"graph prompt {novel} {i}" for i in range(novel)]
    graph = _encode(tiny_cuda, prompts)
    eager = _encode(tiny_cuda, prompts, graphs=False)
    assert graphs.prompt_key(1 << (novel - 1).bit_length()) in tiny_cuda._graphs.captured
    for g, e in zip(graph, eager, strict=True):
        assert all(torch.equal(a, b) for a, b in zip(g, e)) and g[0].abs().sum() > 0


def test_a_cached_prompt_survives_a_later_replay(tiny_cuda):
    """Prompt A, then prompt B at the same padded count: the graph's output
    buffers now hold B, and A's cached row must still hold A."""
    a = _encode(tiny_cuda, ["prompt survives a"])[0]
    b = _encode(tiny_cuda, ["prompt survives b"])[0]
    cached = tiny_cuda._prompt_cache["prompt survives a"]
    assert all(torch.equal(x, y) for x, y in zip(cached, a))
    assert not torch.equal(a[0], b[0])


def test_fp32_prompt_graph_is_captured_without_tf32(tiny_cuda_f32):
    """With TF32 on in the process, an fp32 editor's prompt graph (captured
    here, outside an edit) equals the text encoders run with TF32 off
    (``chip_smoke.py`` also shows TF32 moving them at full width)."""
    from fastedit_tpu_torch.pipeline import graphs, stages

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    prompts = ["an fp32 prompt", "another fp32 prompt"]
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        tiny_cuda_f32._graphs.clear()
        ctx = torch.cat([row[0] for row in _encode(tiny_cuda_f32, prompts)])
        assert graphs.prompt_key(2) in tiny_cuda_f32._graphs.captured
        ids = [torch.from_numpy(np.stack([tok.encode(p) for p in prompts])).long().cuda()
               for tok in (tiny_cuda_f32.tokenizer, tiny_cuda_f32.tokenizer_2)]
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        without = stages.encode_prompt(tiny_cuda_f32.modules, *ids)[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert torch.equal(ctx, without)


def test_http_round_trip_on_the_card(tiny_cuda):
    """One request through ``serve.py``'s HTTP front-end to the tiny editor
    on the card: the PNG it returns is the editor's own edit of the same
    image, prompt and seed."""
    import base64
    import http.client
    import io
    import json
    import threading

    from PIL import Image

    from fastedit_tpu_torch.serve import EditService, make_http_server

    img = _scene(40)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    body = json.dumps({"image": base64.b64encode(buf.getvalue()).decode("ascii"),
                       "prompt": "a served prompt", "seed": 40, "format": "png"})
    with EditService(tiny_cuda, max_batch=2, batch_window_ms=0) as svc:
        httpd = make_http_server(svc, "127.0.0.1", 0, request_timeout_s=300)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=300)
            conn.request("POST", "/v1/edit", body=body)
            resp = conn.getresponse()
            code, out = resp.status, json.loads(resp.read())
            conn.request("GET", "/healthz")
            health = json.loads(conn.getresponse().read())
            conn.close()
        finally:
            httpd.shutdown()
            httpd.server_close()
    assert code == 200, out
    assert health["backend"].startswith("cuda")
    served = np.asarray(Image.open(io.BytesIO(base64.b64decode(out["image"]))).convert("RGB"))
    assert np.array_equal(served, np.asarray(tiny_cuda.edit(img, "a served prompt", seed=40)))


# ------------------------------------------------------- the fp32 kernels


def _f32_conv(gen, n, h, w, cin, cout):
    x = torch.randn((n, h, w, cin), generator=gen, device="cuda")
    wt = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda") * (9 * cin) ** -0.5
          ).contiguous(memory_format=torch.channels_last)
    return x, wt, torch.randn(cout, generator=gen, device="cuda") * 0.1


def _f32_close(out, ref):
    assert out.dtype == torch.float32
    _assert_close(out, ref, F32_REL, F32_ABS_OF_MAX * float(ref.abs().max()))


@pytest.mark.parametrize("mode", ["conv", "fused", "up2", "down2", "down2_asym"])
@pytest.mark.parametrize(
    "n,h,w,cin,cout",
    [
        (2, 13, 37, 96, 320),  # ragged H and W, Cin 96, the 80-wide tile
        (1, 16, 32, 64, 256),  # the 64-wide tile
        (2, 8, 8, 72, 3),  # Cout 3: the 8-wide tile; images smaller than a tile
        (1, 24, 40, 128, 200),  # ragged Cout on the 80-wide tile
    ],
)
def test_f32_conv_kernel_matches_plain(gen, mode, n, h, w, cin, cout):
    if mode.startswith("down2"):
        h, w = 2 * (h // 2), 2 * (w // 2)
    x, wt, bias = _f32_conv(gen, n, h, w, cin, cout)
    before = dict(conv=k.launches_f32, **cf.launches)
    if mode == "conv":
        out = k.conv3x3(x, wt, bias, "silu", w_split=cf.split_tf32(wt))
        ref = k.conv3x3_plain(x, wt, bias, "silu")
    elif mode == "fused":
        pb = torch.randn((n, cout), generator=gen, device="cuda")
        pre = (torch.rand((n, cin), generator=gen, device="cuda") + 0.5,
               torch.randn((n, cin), generator=gen, device="cuda"))
        skip = torch.randn((n, h, w, cout), generator=gen, device="cuda")
        out = cf.conv3x3_fused(x, wt, pb, pre, skip=skip, w_split=cf.split_tf32(wt))
        ref = cf.conv3x3_fused_plain(x, wt, pb, pre, skip=skip)
    elif mode == "up2":
        out = cf.conv3x3_up2(x, wt, bias, w_split=cf.split_up2(wt))
        ref = cf.conv3x3_up2_plain(x, wt, bias)
    else:
        asym = mode == "down2_asym"
        out = cf.conv3x3_down2(x, wt, bias, asymmetric=asym)
        ref = cf.conv3x3_down2_plain(x, wt, bias, asymmetric=asym)
    torch.cuda.synchronize()
    _f32_close(out, ref)
    after = dict(conv=k.launches_f32, **cf.launches)
    name = {"conv": "conv", "fused": "conv3x3_fused_f32", "up2": "conv3x3_up2_f32"}.get(
        mode, "conv3x3_down2_f32")
    assert after[name] == before[name] + 1
    assert all(after[key] == before[key] for key in after if key != name)


@pytest.mark.parametrize("b,sq,skv,h,d", [(1, 128, 128, 2, 64), (2, 256, 384, 3, 64),
                                          (1, 128, 256, 1, 512), (2, 384, 128, 1, 512)])
def test_f32_flash_attention_matches_plain(gen, b, sq, skv, h, d):
    q = torch.randn((b, sq, h, d), generator=gen, device="cuda")
    kv = torch.randn((b, skv, 2, h, d), generator=gen, device="cuda")  # k, v through strides
    kk, v = kv[:, :, 0], kv[:, :, 1]
    before = dict(fa.launches_f32)
    out, ref = fa.flash_attention(q, kk, v, 0.1), fa.attention_plain(q, kk, v, 0.1)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and fa.launches_f32[d] == before[d] + 1
    _assert_close(out, ref, F32_REL, F32_ATTN_ABS_OF_RMS * float(ref.square().mean().sqrt()))
    assert torch.equal(out, fa.flash_attention(q, kk, v, 0.1))  # the same bits twice


@pytest.mark.parametrize("shape,groups,act,offset", [
    ((2, 32, 32, 640), 32, "silu", 0.0),  # resident route
    ((1, 128, 128, 512), 32, None, 0.0),  # read again in part in fp32 (resident in bf16)
    ((2, 16, 16, 2560), 32, None, 50.0),  # one pixel per block row, |mean| >> std
    ((1, 64, 64, 96), 8, "silu", 50.0),
])
def test_f32_group_norm_kernels_match_plain(gen, shape, groups, act, offset):
    x = torch.randn(shape, generator=gen, device="cuda") + offset
    gamma = torch.rand(shape[-1], generator=gen, device="cuda") + 0.5
    beta = torch.randn(shape[-1], generator=gen, device="cuda")
    before = (fg.launches_f32, fg.scale_shift_launches_f32)
    out = fg.fused_group_norm(x, gamma, beta, groups, 1e-5, act)
    sc, sh = fg.group_norm_scale_shift(x, gamma, beta, groups)
    torch.cuda.synchronize()
    _f32_close(out, group_norm_plain(x, gamma, beta, groups, 1e-5, act))
    rs, rsh = group_norm_scale_shift_plain(x, gamma, beta, groups)
    _f32_close(sc, rs)
    _f32_close(sh, rsh)
    assert (fg.launches_f32, fg.scale_shift_launches_f32) == (before[0] + 1, before[1] + 1)
    assert torch.equal(out, fg.fused_group_norm(x, gamma, beta, groups, 1e-5, act))


@pytest.fixture(scope="module")
def tiny_cuda_f32():
    """The tiny editor on the card in fp32 (the quality mode's dtype)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m cuda on a machine with one")
    from fastedit_tpu_torch import FastEditor

    return FastEditor("tiny", use_full_precision=True)


@pytest.mark.parametrize("batch", [1, 2])
def test_f32_editor_graphs_match_the_eager_arm(tiny_cuda_f32, batch):
    imgs, prompts = [_scene(20 + i) for i in range(batch)], ["a red barn"] * batch
    before = k.launches_f32
    graph = _edit(tiny_cuda_f32, imgs, prompts, seed=5)
    eager = _edit(tiny_cuda_f32, imgs, prompts, graphs=False, seed=5)
    _assert_same(graph, eager)
    assert graph[1].dtype == torch.float32 and k.launches_f32 > before


# ---------------------------------------- the fp32 kernels on 3xTF32 (wgmma)


def _fp64_gate(out, plain, single_pass, ref64):
    """chip_smoke.py's gate: within F64_GATE x the plain fp32 version's max
    |err| against fp64, which single-pass TF32 exceeds."""
    errs = [float((t.double() - ref64).abs().max()) for t in (out, plain, single_pass)]
    assert errs[0] <= F64_GATE * errs[1] < errs[2], errs


@pytest.mark.parametrize("asymmetric", [False, True])
@pytest.mark.parametrize("n,h,w,cin,cout", [(1, 64, 64, 96, 256), (2, 32, 32, 320, 320),
                                            (1, 16, 48, 72, 80), (2, 34, 20, 104, 64)])
def test_tf32x3_down2_passes_the_fp64_gate(gen, n, h, w, cin, cout, asymmetric):
    import torch.nn.functional as F

    from fastedit_tpu_torch.ops import tf32x3

    x, wt, bias = _f32_conv(gen, n, h, w, cin, cout)
    pad = (0, 1, 0, 1) if asymmetric else (1, 1, 1, 1)
    ref64 = F.conv2d(F.pad(x.double().permute(0, 3, 1, 2), pad), wt.double(), bias.double(),
                     stride=2).permute(0, 2, 3, 1)
    out = cf.conv3x3_down2(x, wt, bias, asymmetric=asymmetric)
    _f32_close(out, cf.conv3x3_down2_plain(x, wt, bias, asymmetric=asymmetric))
    _fp64_gate(out, cf.conv3x3_down2_plain(x, wt, bias, asymmetric=asymmetric),
               tf32x3.conv3x3_down2_plain(x, wt, bias, asymmetric=asymmetric, passes=1), ref64)


@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 64, 64, 320, 320), (1, 32, 48, 96, 96),
                                            (2, 16, 40, 72, 4), (1, 24, 16, 104, 200),
                                            (1, 64, 64, 128, 3), (2, 8, 8, 1280, 640)])
def test_tf32x3_conv_passes_the_fp64_gate(gen, n, h, w, cin, cout):
    import torch.nn.functional as F

    from fastedit_tpu_torch.ops import tf32x3

    x, wt, bias = _f32_conv(gen, n, h, w, cin, cout)
    ref64 = F.conv2d(x.double().permute(0, 3, 1, 2), wt.double(), bias.double(),
                     padding=1).permute(0, 2, 3, 1)
    out = k.conv3x3(x, wt, bias, w_split=cf.split_tf32(wt))
    plain = k.conv3x3_plain(x, wt, bias)
    _f32_close(out, plain)
    _fp64_gate(out, plain, tf32x3.conv3x3_plain(x, wt, bias, passes=1), ref64)


def test_tf32x3_conv_refuses_an_fp32_call_without_the_split(gen):
    x, wt, bias = _f32_conv(gen, 1, 16, 16, 64, 64)
    before = (k.launches_f32, dict(cf.launches))
    with pytest.raises(ValueError, match="w_split"):
        k.conv3x3(x, wt, bias)
    with pytest.raises(ValueError, match="w_split"):
        k.conv3x3(x, wt, bias, w_split=(wt, wt.contiguous()))  # OIHW memory, not channels_last
    with pytest.raises(ValueError, match="w_split"):
        cf.conv3x3_fused(x, wt, bias)
    with pytest.raises(ValueError, match="w_split"):
        cf.conv3x3_up2(x, wt, bias)
    with pytest.raises(ValueError, match="w_split"):  # the weight's split, not the phases'
        cf.conv3x3_up2(x, wt, bias, w_split=cf.split_tf32(wt))
    assert (k.launches_f32, cf.launches) == before


@pytest.mark.parametrize("n,h,w,cin,cout,per_batch_bias,skip",
                         [(1, 32, 48, 512, 512, False, True), (2, 24, 40, 96, 200, True, True),
                          (1, 16, 16, 72, 4, False, False), (2, 40, 24, 128, 128, True, False),
                          (1, 64, 64, 256, 256, False, True)])
def test_tf32x3_fused_conv_passes_the_fp64_gate(gen, n, h, w, cin, cout, per_batch_bias, skip):
    """The fused conv at the VAE decoder's widths (Cout 512, 256, 128: the
    64-wide tile), a ragged Cin and Cout, the Cout <= 8 tail; per-channel
    scale and shift (a channel the prologue maps wrongly shows), a per-batch
    bias and a skip; against the plain version and fp64.  The prologue leaves
    the padding ring zero: the same conv with the ring mapped too fails."""
    import torch.nn.functional as F

    from fastedit_tpu_torch.ops import tf32x3

    x, wt, bias = _f32_conv(gen, n, h, w, cin, cout)
    if per_batch_bias:
        bias = torch.randn((n, cout), generator=gen, device="cuda") * 0.1
    pre = (torch.rand((n, cin), generator=gen, device="cuda") + 0.5,
           torch.randn((n, cin), generator=gen, device="cuda") * 0.5)
    sk = torch.randn((n, h, w, cout), generator=gen, device="cuda") if skip else None
    before = cf.launches["conv3x3_fused_f32"]
    out = cf.conv3x3_fused(x, wt, bias, pre, skip=sk, w_split=cf.split_tf32(wt))
    assert cf.launches["conv3x3_fused_f32"] == before + 1
    plain = cf.conv3x3_fused_plain(x, wt, bias, pre, skip=sk)
    _f32_close(out, plain)
    xin = F.silu(x.double() * pre[0].double()[:, None, None, :] + pre[1].double()[:, None, None, :])
    ref64 = F.conv2d(xin.permute(0, 3, 1, 2), wt.double(), padding=1).permute(0, 2, 3, 1)
    ref64 = ref64 + (bias.double()[:, None, None, :] if bias.dim() == 2 else bias.double())
    if sk is not None:
        ref64 = ref64 + sk.double()
    _fp64_gate(out, plain, tf32x3.conv3x3_fused_plain(x, wt, bias, pre, skip=sk, passes=1),
               ref64)
    ring = cf.prologue_plain(F.pad(x, (0, 0, 1, 1, 1, 1)), *pre)
    wrong = F.conv2d(ring.permute(0, 3, 1, 2), wt).permute(0, 2, 3, 1)
    wrong = wrong + (bias[:, None, None, :] if bias.dim() == 2 else bias)
    with pytest.raises(AssertionError):
        _f32_close(out, wrong if sk is None else wrong + sk)
    assert torch.equal(out, cf.conv3x3_fused(x, wt, bias, pre, skip=sk,
                                             w_split=cf.split_tf32(wt)))  # the same bits twice


@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 32, 32, 1280, 1280), (2, 16, 24, 640, 640),
                                            (1, 40, 24, 512, 512), (1, 13, 21, 72, 200),
                                            (2, 8, 8, 96, 4)])
def test_tf32x3_up2_conv_passes_the_fp64_gate(gen, n, h, w, cin, cout):
    """The upsample conv at the UNet's widths (the 80-wide tile), the VAE's
    (64-wide), a ragged Cin, Cout and input, the Cout <= 8 tail; against the
    plain version and fp64, on the phase weights folded in fp32 and split
    once; a phase with its tap rows swapped fails."""
    import torch.nn.functional as F

    from fastedit_tpu_torch.ops import tf32x3

    x, wt, bias = _f32_conv(gen, n, h, w, cin, cout)
    w_split = cf.split_up2(wt)
    before = cf.launches["conv3x3_up2_f32"]
    out = cf.conv3x3_up2(x, wt, bias, "silu", w_split=w_split)
    assert cf.launches["conv3x3_up2_f32"] == before + 1
    plain = cf.conv3x3_up2_plain(x, wt, bias, "silu")
    _f32_close(out, plain)
    out = cf.conv3x3_up2(x, wt, bias, w_split=w_split)
    up = x.double().permute(0, 3, 1, 2).repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    ref64 = F.conv2d(up, wt.double(), bias.double(), padding=1).permute(0, 2, 3, 1)
    plain = cf.conv3x3_up2_plain(x, wt, bias)
    _fp64_gate(out, plain, tf32x3.conv3x3_up2_plain(x, wt, bias, passes=1), ref64)
    phases = cf.make_phase_kernels(wt)
    phases[1, 1] = phases[1, 1].flip(0).clone()
    with pytest.raises(AssertionError):
        _f32_close(out, cf.up2_phases_plain(x, phases, bias))
    assert torch.equal(out, cf.conv3x3_up2(x, wt, bias, w_split=w_split))


@pytest.mark.parametrize("b,sq,skv,h,d,scale", [(1, 128, 256, 1, 512, 512**-0.5),
                                                (2, 384, 128, 1, 512, 0.1),
                                                (1, 1024, 1024, 1, 512, 512**-0.5),
                                                (1, 256, 128, 3, 64, 0.125),
                                                (2, 256, 384, 2, 64, 0.3),
                                                (1, 1024, 1024, 4, 64, 0.125)])
def test_tf32x3_attention_passes_the_fp64_gate(gen, b, sq, skv, h, d, scale):
    from fastedit_tpu_torch.ops import tf32x3

    q = torch.randn((b, sq, h, d), generator=gen, device="cuda")
    kv = torch.randn((b, skv, 2, h, d), generator=gen, device="cuda")  # through strides
    kk, v = kv[:, :, 0], kv[:, :, 1]
    qd, kd, vd = (t.double().transpose(1, 2) for t in (q, kk, v))
    ref64 = (torch.softmax((qd @ kd.transpose(-1, -2)) * scale, -1) @ vd).transpose(1, 2)
    out = fa.flash_attention(q, kk, v, scale)
    _fp64_gate(out, fa.attention_plain(q, kk, v, scale),
               tf32x3.attention_plain(q, kk, v, scale, passes=1), ref64)


def test_tf32x3_geometry_mirrors_the_plans(gen):
    from fastedit_tpu_torch.ops.build import library

    conv = library("conv3x3_tf32x3")
    for bn in (64, 80):
        assert [conv.conv3x3_tf32x3_geometry(2, bn, i) for i in (0, 1, 2, 3)] == \
            [k.smem_bytes_down2_f32(bn), k.down2_f32_weight_stages(bn), 32,
             k.DOWN2_PLANE_STAGES]
    for bn in k.CONV_F32_BN:  # forms 1 stride 1, 3 fused, 4 up2
        for form, pl, threads in (
                (1, k.plan(2, 64, 64, 320, bn, itemsize=4), 288),
                (3, k.plan(2, 64, 64, 320, bn, itemsize=4, fused=True), 384),
                (4, k.plan_up2(2, 64, 64, 320, bn, itemsize=4), 288)):
            assert pl.bn == bn
            assert [conv.conv3x3_tf32x3_geometry(form, bn, i) for i in (0, 1, 2, 3, 4)] == \
                [pl.smem_bytes, pl.weight_stages, pl.chunk, k.CONV_F32_HALO_STAGES, threads]
    assert conv.conv3x3_tf32x3_geometry(2, 160, 0) == conv.conv3x3_tf32x3_geometry(1, 16, 0) == -1
    assert conv.conv3x3_tf32x3_geometry(2, 8, 0) == conv.conv3x3_tf32x3_geometry(5, 64, 0) == -1
    attn = library("flash_attention_tf32x3")
    pl = fa.plan_f32(1, 16384, 16384, 1, 512)
    assert [attn.flash_d512_tf32x3_geometry(i) for i in range(1, 8)] == [
        pl.bkv, pl.stages, pl.smem_bytes, pl.v_stages, pl.v_keys, pl.bq,
        fa.TF32X3_FRAG_FLOATS + pl.bq]
    pl = fa.plan_f32(2, 1024, 1024, 20, 64)
    assert [attn.flash_d64_tf32x3_geometry(i) for i in (1, 2, 3, 6)] == [
        pl.bkv, pl.stages, pl.smem_bytes, pl.bq]


def test_tf32x3_split_kernel_gives_the_emulations_bits(gen):
    from fastedit_tpu_torch.ops import tf32x3

    w = (torch.randn((320, 96, 3, 3), generator=gen, device="cuda")
         * torch.exp2(torch.randint(-20, 20, (320, 1, 1, 1), generator=gen, device="cuda"))
         ).contiguous(memory_format=torch.channels_last)
    for got, want in zip(cf.split_tf32(w), tf32x3.split_tf32(w), strict=True):
        assert torch.equal(got, want) and got.is_contiguous(memory_format=torch.channels_last)


def test_tf32x3_kernels_under_graph_replays_equal_eager(gen):
    x, wt, bias = _f32_conv(gen, 2, 32, 32, 320, 320)
    w_split = cf.split_tf32(wt)
    q = torch.randn((1, 256, 1, 512), generator=gen, device="cuda")
    kk, v = (torch.randn((1, 256, 1, 512), generator=gen, device="cuda") for _ in range(2))
    q64, kk64, v64 = (torch.randn((2, 256, 3, 64), generator=gen, device="cuda")
                      for _ in range(3))

    pre = (torch.rand((2, 320), generator=gen, device="cuda") + 0.5,
           torch.randn((2, 320), generator=gen, device="cuda"))
    up2_split = cf.split_up2(wt)

    def calls():
        return (cf.conv3x3_down2(x, wt, bias, w_split=w_split), fa.flash_attention(q, kk, v),
                k.conv3x3(x, wt, bias, w_split=w_split), fa.flash_attention(q64, kk64, v64),
                cf.conv3x3_fused(x, wt, bias, pre, skip=x, w_split=w_split),
                cf.conv3x3_up2(x, wt, bias, w_split=up2_split))

    eager = calls()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            outs = calls()
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(outs, eager, strict=True):
            assert torch.equal(got, want)
