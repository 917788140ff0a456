"""The port's CUDA kernels against their plain versions, on a card.

These tests need an NVIDIA card with ``nvcc``; they carry the ``cuda``
marker and skip without a card.  On a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Shapes are small but cover what the main path's shapes exercise: ragged
Cin (72, 320) and Cout (3, 4, 8), several output tiles, the SiLU epilogue,
no bias, attention read through strides (q, k, v as slices of one fused
projection), Sq != Skv, and both head dims.  Tolerances are those of
``chip_smoke.py`` (both sides accumulate in fp32 and round once to bf16;
the attention's absolute term scales with the output's RMS).
"""

import pytest
import torch

from chip_smoke import ATTN_ABS_OF_RMS, ATTN_REL, CONV_ABS_OF_MAX, CONV_REL
from fastedit_tpu_torch.ops import conv3x3 as k
from fastedit_tpu_torch.ops import flash_attention as fa

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
    assert (k.launches, fa.launches) == before
