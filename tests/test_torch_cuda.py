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
D = 64 shapes and batch 4, and both head dims; for the fused resnet, up2 and
down2 convs, the prologue, per-batch bias and skip, both down2 paddings,
Cin 96, all four stride-2 channel tiles and odd-sized inputs; for the GroupNorm kernel, a large mean offset and more
than 2048 channels.  Tolerances are those of ``chip_smoke.py`` (both sides
accumulate in fp32 and round once to bf16; the attention's absolute term
scales with the output's RMS).
"""

import pytest
import torch

from chip_smoke import ATTN_ABS_OF_RMS, ATTN_REL, CONV_ABS_OF_MAX, CONV_REL
from fastedit_tpu_torch.ops import conv3x3 as k
from fastedit_tpu_torch.ops import conv_fused as cf
from fastedit_tpu_torch.ops import flash_attention as fa
from fastedit_tpu_torch.ops import fused_groupnorm as fg
from fastedit_tpu_torch.ops.groupnorm import group_norm_plain

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


@pytest.mark.parametrize("d", [64, 512])
def test_flash_attention_gives_the_same_bits_twice(gen, d):
    """No split sums between blocks and no atomics: persistent blocks walk
    their tiles in whatever interleaving, and two launches agree bit for
    bit."""
    b, s, h = (2, 1024, 5) if d == 64 else (1, 256, 1)
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


def test_attention_plan_mirrors_the_kernels_geometry(gen):
    from fastedit_tpu_torch.ops.build import library

    lib = library("flash_attention")
    for d in fa.HEAD_DIMS:
        bkv, stages = fa.GEOMETRY[d][:2]
        for bq in fa.Q_TILES[d]:
            assert [lib.flash_attention_geometry(d, bq, i) for i in (1, 2, 3)] == \
                [bkv, stages, fa.smem_bytes(d, bq)]
            assert fa.smem_bytes(d, bq) <= k.SMEM_LIMIT
    assert lib.flash_attention_geometry(96, 128, 1) == -1
    assert lib.flash_attention_geometry(64, 256, 1) == -1


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


def test_wrappers_raise_outside_their_contract(gen):
    x = torch.randn((1, 8, 8, 64), generator=gen, device="cuda")
    w = torch.randn((64, 64, 3, 3), generator=gen, device="cuda")
    before = (k.launches, dict(fa.launches))
    with pytest.raises(TypeError):  # fp32 is a later slice
        k.conv3x3(x, w.contiguous(memory_format=torch.channels_last))
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
