"""The port's ops (fastedit_tpu_torch.ops) against the JAX package's.

Inputs come from numpy with a fixed seed and go through both.  Where the
JAX function reaches a Pallas kernel it runs in interpret mode, as the JAX
package's own kernel tests run it on the CPU.  On the CPU the port's
kernel wrappers run their plain versions, which is what is compared here;
the CUDA kernels themselves are held against those plain versions on the
card by chip_smoke.py.  Tolerance: fp32, rtol = atol = 2e-4 (the repo's
golden tolerance) unless stated.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastedit_tpu.models import configs as JC
from fastedit_tpu.ops import flags as jflags
from fastedit_tpu.ops import conv3x3 as jconv3x3
from fastedit_tpu.ops import flash_attention as jfa
from fastedit_tpu.ops.attention import attention_xla
from fastedit_tpu.ops.conv import conv3x3_same as jconv3x3_same
from fastedit_tpu.ops.groupnorm import group_norm_scale_shift as jgn_scale_shift
from fastedit_tpu.ops.groupnorm import group_norm_xla

from fastedit_tpu_torch.models import configs as TC
from fastedit_tpu_torch.ops.attention import attention as tattention
from fastedit_tpu_torch.ops import conv as tconv
from fastedit_tpu_torch.ops import conv3x3 as tconv3x3
from fastedit_tpu_torch.ops import flags as tflags
from fastedit_tpu_torch.ops import flash_attention as tfa
from fastedit_tpu_torch.ops.groupnorm import group_norm, group_norm_scale_shift
from fastedit_tpu_torch.tools import inventory

TOL = dict(rtol=2e-4, atol=2e-4)


def _rng(seed):
    return np.random.default_rng(seed)


def _nhwc_to_hwio(w_oihw):
    return np.transpose(w_oihw, (2, 3, 1, 0))


# ------------------------------------------------------------- group norm


@pytest.mark.parametrize(
    "shape,groups,act,offset",
    [
        ((2, 8, 8, 64), 32, None, 0.0),
        ((1, 16, 16, 32), 8, "silu", 0.0),
        # |mean| >> std: the case the two-pass variance exists for
        ((1, 8, 8, 64), 32, "silu", 300.0),
    ],
)
def test_group_norm_matches_jax(shape, groups, act, offset):
    r = _rng(0)
    x = (r.standard_normal(shape) * 0.5 + offset).astype(np.float32)
    gamma = r.standard_normal(shape[-1]).astype(np.float32)
    beta = r.standard_normal(shape[-1]).astype(np.float32)
    ref = group_norm_xla(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                         num_groups=groups, eps=1e-6, act=act)
    out = group_norm(torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta),
                     num_groups=groups, eps=1e-6, act=act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_group_norm_scale_shift_matches_jax():
    r = _rng(1)
    x = (r.standard_normal((2, 8, 8, 64)) + 50.0).astype(np.float32)
    gamma = r.standard_normal(64).astype(np.float32)
    beta = r.standard_normal(64).astype(np.float32)
    rs, rsh = jgn_scale_shift(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), 32)
    s, sh = group_norm_scale_shift(torch.from_numpy(x), torch.from_numpy(gamma),
                                   torch.from_numpy(beta), 32)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), **TOL)
    np.testing.assert_allclose(sh.numpy(), np.asarray(rsh), rtol=2e-4, atol=2e-3)


# ------------------------------------------------------------------ conv


@pytest.mark.parametrize(
    "b,hw,cin,cout,act,bias",
    [
        (1, 8, 128, 128, None, True),
        (2, 8, 64, 128, "silu", True),
        (1, 8, 320, 128, None, True),  # ragged Cin (UNet 320-channel stage)
        (1, 8, 128, 3, None, True),  # VAE conv_out tail
        (1, 8, 320, 4, None, False),  # UNet conv_out tail
    ],
)
def test_conv3x3_plain_matches_pallas_interpret(b, hw, cin, cout, act, bias):
    r = _rng(2)
    x = r.standard_normal((b, hw, hw, cin)).astype(np.float32)
    w = (r.standard_normal((cout, cin, 3, 3)) / np.sqrt(9 * cin)).astype(np.float32)
    bs = r.standard_normal(cout).astype(np.float32) if bias else None
    with jflags.override(pallas_interpret=True):
        ref = jconv3x3.conv3x3(
            jnp.asarray(x), jnp.asarray(_nhwc_to_hwio(w)),
            bias=None if bs is None else jnp.asarray(bs), act=act,
        )
    wt = torch.from_numpy(w).contiguous(memory_format=torch.channels_last)
    out = tconv3x3.conv3x3(torch.from_numpy(x), wt,
                           bias=None if bs is None else torch.from_numpy(bs), act=act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("cin", [3, 32])
def test_conv_dispatch_outside_gate_matches_jax(cin):
    """Stems below Cin 64 take PyTorch's conv, as JAX sends them to XLA."""
    r = _rng(3)
    x = r.standard_normal((1, 8, 8, cin)).astype(np.float32)
    w = r.standard_normal((16, cin, 3, 3)).astype(np.float32)
    bs = r.standard_normal(16).astype(np.float32)
    assert not tconv3x3.supports(x.shape, w.shape)
    ref = jconv3x3_same(jnp.asarray(x), jnp.asarray(_nhwc_to_hwio(w)),
                        bias=jnp.asarray(bs), act="silu")
    out = tconv.conv3x3_same(torch.from_numpy(x), torch.from_numpy(w),
                             bias=torch.from_numpy(bs), act="silu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_conv_override_selects_plain_version():
    """Outside a stage the plan takes no conv kernel (the JAX package's
    unmeasured-context default) and PyTorch's conv runs; in the denoise loop
    the kernel's path runs, and ``plain_versions`` selects the kernel's
    plain version in its place.  On the CPU all three agree."""
    r = _rng(4)
    x = torch.from_numpy(r.standard_normal((1, 8, 8, 64)).astype(np.float32))
    w = torch.from_numpy(r.standard_normal((64, 64, 3, 3)).astype(np.float32))
    shapes = (tuple(x.shape), tuple(w.shape))
    assert not tflags.takes("conv3x3", *shapes)
    library = tconv.conv3x3_same(x, w)
    with tflags.stage("denoise"):
        assert tflags.takes("conv3x3", *shapes)
        kernel = tconv.conv3x3_same(x, w)
        with tflags.override(plain_versions=True):
            assert tflags.kernel_or_plain(tconv3x3.conv3x3, tconv3x3.conv3x3_plain) \
                is tconv3x3.conv3x3_plain
            plain = tconv.conv3x3_same(x, w)
    assert not tflags.takes("conv3x3", *shapes) and not tflags.FLAGS.plain_versions
    torch.testing.assert_close(kernel, library, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(plain, kernel)
    with pytest.raises(AttributeError):
        with tflags.override(use_pallas_conv=True):
            pass


# ------------------------------------------------------------- attention


@pytest.mark.parametrize(
    "b,s,h,d",
    [
        (1, 128, 2, 64),  # JAX: head-packed kernel (_flash_packed)
        (2, 256, 2, 64),  # packed, two kv blocks of 128 rows each side
        (1, 128, 1, 512),  # JAX: one head per grid row (_flash_bhsd), VAE width
    ],
)
def test_attention_plain_matches_flash_interpret(b, s, h, d):
    r = _rng(5)
    q, k, v = (r.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    assert jfa.supports((b, s, h, d), s)
    with jflags.override(pallas_interpret=True):
        ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_cross_attention_takes_plain_path():
    r = _rng(6)
    q = r.standard_normal((2, 128, 2, 64)).astype(np.float32)
    k, v = (r.standard_normal((2, 77, 2, 64)).astype(np.float32) for _ in range(2))
    assert not tfa.supports(q.shape, 77)
    ref = attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = tattention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("op", ["conv", "attention"])
def test_non_cpu_tensor_never_takes_plain_version(op):
    """A tensor off the CPU goes to the kernel or raises: here (meta tensors,
    no card, no nvcc) it must raise, never return the plain result."""
    if op == "conv":
        x = torch.empty((1, 8, 8, 64), dtype=torch.bfloat16, device="meta")
        w = torch.empty((64, 64, 3, 3), dtype=torch.bfloat16, device="meta")
        call = lambda: tconv3x3.conv3x3(x, w.contiguous(memory_format=torch.channels_last))  # noqa: E731
        before = tconv3x3.launches
    else:
        x = torch.empty((1, 128, 2, 64), dtype=torch.bfloat16, device="meta")
        call = lambda: tfa.flash_attention(x, x, x)  # noqa: E731
        before = dict(tfa.launches)
    with pytest.raises((RuntimeError, ValueError, TypeError, NotImplementedError)):
        call()
    assert (tconv3x3.launches if op == "conv" else tfa.launches) == before


def test_kernel_wrappers_reject_fp32_off_cpu():
    """fp32 off the CPU goes to the fp32 kernel (the quality mode) or raises:
    here (meta tensors, no card) it raises and counts no launch, never
    returning the plain version's result; a dtype no kernel takes raises a
    TypeError."""
    x = torch.empty((1, 128, 1, 64), dtype=torch.float32, device="meta")
    xc = torch.empty((1, 8, 8, 64), dtype=torch.float32, device="meta")
    wc = torch.empty((64, 64, 3, 3), dtype=torch.float32, device="meta")
    before = (tconv3x3.launches_f32, dict(tfa.launches_f32))
    with pytest.raises((RuntimeError, ValueError)):
        tfa.flash_attention(x, x, x)
    with pytest.raises((RuntimeError, ValueError)):
        tconv3x3.conv3x3(xc, wc)
    assert (tconv3x3.launches_f32, dict(tfa.launches_f32)) == before
    with pytest.raises(TypeError):
        tfa.flash_attention(x.half(), x.half(), x.half())
    with pytest.raises(TypeError):
        tconv3x3.conv3x3(xc.double(), wc.double())


# ------------------------------------------------------------ gate parity


def _port_conv_inventory():
    shapes = set()
    for ucfg in (TC.SSD1B_UNET, TC.SDXL_UNET):
        for cn in (TC.SDXL_CONTROLNET_SMALL, TC.SDXL_CONTROLNET_FULL):
            conv, _ = inventory.edit_calls(ucfg, cn, TC.SDXL_VAE, 1024)
            shapes.update((h, w, cin, cout) for (_, h, w, cin, cout) in conv)
    return shapes


def test_conv_gate_matches_jax_over_the_shape_inventory():
    """Over the SSD-1B / SDXL / ControlNet / VAE shape inventory at 1024²,
    the port's conv gate admits exactly the calls the JAX gate admits in
    bf16 (the JAX package's own inventory and the port's)."""
    import test_conv3x3_vmem as jinv

    shapes = set(jinv._inventory()) | _port_conv_inventory()
    admitted = 0
    for h, w, cin, cout in sorted(shapes):
        x_shape = (1, h, w, cin)
        port = tconv3x3.supports(x_shape, (cout, cin, 3, 3))
        ref = jconv3x3.supports(x_shape, (3, 3, cin, cout), 2)
        assert port == ref, (h, w, cin, cout, port, ref)
        admitted += port
    assert admitted >= 20


def test_attention_gate_matches_jax_over_the_shape_inventory():
    admitted = 0
    for ucfg in (TC.SSD1B_UNET, TC.SDXL_UNET):
        _, attn = inventory.edit_calls(ucfg, TC.SDXL_CONTROLNET_FULL, TC.SDXL_VAE, 1024)
        for b, sq, skv, h, d in attn:
            port = tfa.supports((b, sq, h, d), skv)
            ref = jfa.supports((b, sq, h, d), skv)
            assert port == ref, (b, sq, skv, h, d)
            admitted += port
    assert admitted >= 4  # D = 64 at two sequence lengths, D = 512 in the VAE


def test_port_config_copy_matches_jax_configs():
    for name in ("SDXL_UNET", "SSD1B_UNET", "TINY_UNET", "SDXL_CONTROLNET_SMALL",
                 "SDXL_CONTROLNET_FULL", "TINY_CONTROLNET", "SDXL_VAE", "TINY_VAE",
                 "SDXL_TEXT_ENCODER", "SDXL_TEXT_ENCODER_2", "TINY_TEXT_ENCODER",
                 "TINY_TEXT_ENCODER_2"):
        assert repr(getattr(TC, name)) == repr(getattr(JC, name)), name
