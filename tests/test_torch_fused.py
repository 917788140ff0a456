"""The port's fused conv kernels, GroupNorm kernel and per-context kernel
flags against the JAX package's.

Inputs come from numpy with a fixed seed and go through both.  The JAX side
runs its Pallas kernels in interpret mode (``pallas_interpret=True``) and,
where the JAX package's defaults on its accelerator are meant, with
``flags._on_tpu`` patched to True, as ``tests/test_flags_contexts.py`` does;
nothing in the JAX package changes.  On the CPU the port's kernel wrappers
run their plain versions, which is what is compared here; the CUDA kernels
themselves are held against those plain versions on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).  Tolerance: fp32,
rtol = atol = 2e-4 (the repo's golden tolerance); the uint8 editor output
may differ by 1 LSB.  The tiny editor is compared as a whole: the JAX
tiny editor's interpreted edit takes ~16 s on one CPU core.
"""

import dataclasses
import itertools
from collections import Counter
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastedit_tpu.models import configs as JC
from fastedit_tpu.models import resnet as jresnet
from fastedit_tpu.models.vae import AutoencoderKL as JVAE
from fastedit_tpu.ops import conv_fused as jcf
from fastedit_tpu.ops import flags as jflags
from fastedit_tpu.ops import fused_groupnorm as jgn

from fastedit_tpu_torch.models import configs as TC
from fastedit_tpu_torch.models import resnet as tresnet
from fastedit_tpu_torch.models.vae import AutoencoderKL
from fastedit_tpu_torch.ops import canny as tcanny
from fastedit_tpu_torch.ops import conv3x3 as tconv3x3
from fastedit_tpu_torch.ops import conv_fused as tcf
from fastedit_tpu_torch.ops import flags as tflags
from fastedit_tpu_torch.ops import flash_attention as tfa
from fastedit_tpu_torch.ops import fused_groupnorm as tgn
from fastedit_tpu_torch.ops import layer_norm as tln
from fastedit_tpu_torch.pipeline import stages as tstages
from fastedit_tpu_torch.tools import from_jax, inventory
from test_torch_pipeline import _assert_within_1_lsb, _img, carried_editors

TOL = dict(rtol=2e-4, atol=2e-4)


def _rng(seed):
    return np.random.default_rng(seed)


def _on_tpu():
    """The JAX package's flags as on its accelerator, kernels interpreted."""
    return mock.patch.object(jflags, "_on_tpu", lambda: True)


def _hwio(w_oihw):
    return np.transpose(w_oihw, (2, 3, 1, 0))


def _cl(w):
    return torch.from_numpy(w).contiguous(memory_format=torch.channels_last)


# ------------------------------------------------------------------ flags


FIELDS = ("use_cuda_conv", "use_fused_resnet", "use_fused_up2", "use_fused_down2")
JAX_FIELD = {"use_cuda_conv": "use_pallas_conv"}


def _jax_stage_overrides(name):
    """The overrides the JAX package's stages set around their bodies
    (pipeline/stages.py there), written out."""
    if name == "denoise":
        r, u = jflags.resolve_fused_denoise()
        return dict(use_pallas_conv=jflags.use_pallas_conv_denoise(), use_fused_resnet=r,
                    use_fused_up2=u, use_fused_down2=jflags.resolve_fused_down2_denoise())
    if name == "decode":
        r, u = jflags.resolve_fused_decode()
        return dict(use_pallas_conv=jflags.use_pallas_conv_decode(), use_fused_resnet=r,
                    use_fused_up2=u)
    r, d = jflags.resolve_fused_encode()
    return dict(use_pallas_conv=jflags.use_pallas_conv_encode(), use_fused_resnet=r,
                use_fused_down2=d)


@pytest.mark.parametrize("values", list(itertools.product((None, True, False), repeat=4)),
                         ids=lambda v: "-".join(str(x) for x in v))
def test_flags_resolve_as_jax_on_its_accelerator(values):
    setting = dict(zip(FIELDS, values))
    with _on_tpu(), jflags.override(**{JAX_FIELD.get(k, k): v for k, v in setting.items()}), \
            tflags.override(**setting):
        pairs = [
            (tflags.use_cuda_conv, jflags.use_pallas_conv),
            (tflags.use_cuda_conv_denoise, jflags.use_pallas_conv_denoise),
            (tflags.use_cuda_conv_decode, jflags.use_pallas_conv_decode),
            (tflags.use_cuda_conv_encode, jflags.use_pallas_conv_encode),
            (tflags.use_fused_resnet, jflags.use_fused_resnet),
            (tflags.use_fused_up2, jflags.use_fused_up2),
            (tflags.use_fused_down2, jflags.use_fused_down2),
            (tflags.resolve_fused_encode, jflags.resolve_fused_encode),
            (tflags.resolve_fused_denoise, jflags.resolve_fused_denoise),
            (tflags.resolve_fused_down2_denoise, jflags.resolve_fused_down2_denoise),
            (tflags.resolve_fused_decode, jflags.resolve_fused_decode),
        ]
        for port, ref in pairs:
            assert port() == ref(), (port.__name__, setting)
        for stage in tflags.STAGES:
            port = {JAX_FIELD.get(k, k): v for k, v in tflags.stage_overrides(stage).items()}
            assert port == _jax_stage_overrides(stage), (stage, setting)


@pytest.mark.parametrize("value", [None, True, False])
def test_groupnorm_and_attention_flags_as_jax(value):
    """Set, both flags follow the JAX package's.  Unset, the GroupNorm kernel
    is on in the port, its one stated departure from the JAX defaults
    (``ops/flags.py``), and off in the JAX package."""
    with _on_tpu(), jflags.override(use_pallas_groupnorm=value, use_pallas_attention=value), \
            tflags.override(use_cuda_groupnorm=value, use_cuda_attention=value):
        if value is None:
            assert tflags.use_cuda_groupnorm() and not jflags.use_pallas_groupnorm()
        else:
            assert tflags.use_cuda_groupnorm() == jflags.use_pallas_groupnorm()
        assert tflags.use_cuda_attention() == jflags.use_pallas_attention()


def test_stage_scopes_and_restores_the_flags():
    with tflags.stage("decode"):
        assert tflags.use_cuda_conv() and tflags.use_fused_resnet() and tflags.use_fused_up2()
    with tflags.stage("denoise"):
        assert tflags.use_fused_down2() and not tflags.use_fused_resnet()
    with tflags.stage("encode"):
        assert not (tflags.use_cuda_conv() or tflags.use_fused_resnet()
                    or tflags.use_fused_down2())
    assert tflags.FLAGS == tflags.KernelFlags()
    with pytest.raises(ValueError):
        with tflags.stage("prepare"):
            pass


def test_cuda_graphs_flag_is_on_unless_turned_off_or_plain():
    """``cuda_graphs``, the counterpart of ``jax.disable_jit`` (off = eager):
    on by default, off when set so or under ``plain_versions``, which no
    stage context changes."""
    assert tflags.FLAGS.cuda_graphs and tflags.use_cuda_graphs()
    for stage in tflags.STAGES:
        with tflags.stage(stage):
            assert tflags.use_cuda_graphs()
    with tflags.override(cuda_graphs=False):
        assert not tflags.use_cuda_graphs()
        with tflags.stage("denoise"):
            assert not tflags.use_cuda_graphs()
    with tflags.override(plain_versions=True):
        assert not tflags.use_cuda_graphs()
    assert tflags.FLAGS == tflags.KernelFlags()


# ------------------------------------------------------------- conv ops


@pytest.mark.parametrize(
    "b,cin,cout,prenorm,per_batch_bias,skip,act",
    [
        (2, 72, 64, True, True, True, "silu"),  # Cin 72: JAX pads it to 128
        (1, 64, 128, True, False, True, None),  # the decoder's conv2 form
        (2, 128, 96, True, True, False, None),  # the UNet's conv1 form, ragged Cout
        (1, 64, 64, False, False, False, None),  # no fusion operands at all
    ],
)
def test_conv3x3_fused_matches_jax(b, cin, cout, prenorm, per_batch_bias, skip, act):
    r = _rng(10)
    x = r.standard_normal((b, 8, 8, cin)).astype(np.float32)
    w = (r.standard_normal((cout, cin, 3, 3)) / np.sqrt(9 * cin)).astype(np.float32)
    bias = r.standard_normal((b, cout) if per_batch_bias else (cout,)).astype(np.float32)
    pre = ((r.uniform(0.5, 1.5, (b, cin)).astype(np.float32),
            r.standard_normal((b, cin)).astype(np.float32)) if prenorm else None)
    sk = r.standard_normal((b, 8, 8, cout)).astype(np.float32) if skip else None
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    assert jcf.supports_fused(x.shape, _hwio(w).shape, 4, skip)
    with jflags.override(pallas_interpret=True):
        ref = jcf.conv3x3_fused(jnp.asarray(x), jnp.asarray(_hwio(w)), j(bias),
                                None if pre is None else tuple(map(jnp.asarray, pre)),
                                act, j(sk))
    out = tcf.conv3x3_fused(torch.from_numpy(x), _cl(w), t(bias),
                            None if pre is None else tuple(map(torch.from_numpy, pre)),
                            act, t(sk))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_make_phase_kernels_matches_jax():
    r = _rng(11)
    w = r.standard_normal((24, 72, 3, 3)).astype(np.float32)
    ref = np.asarray(jcf.make_phase_kernels(jnp.asarray(_hwio(w))))  # [p,q,a,b,Cin,Cout]
    out = tcf.make_phase_kernels(torch.from_numpy(w)).numpy()  # [p,q,a,b,Cout,Cin]
    np.testing.assert_allclose(out, np.swapaxes(ref, -1, -2), **TOL)
    # bf16: fp32 tap sums rounded once, as the JAX package does
    wb = jnp.asarray(_hwio(w)).astype(jnp.bfloat16)
    ref_b = np.asarray(jcf.make_phase_kernels(wb).astype(jnp.float32))
    out_b = tcf.make_phase_kernels(torch.from_numpy(w).bfloat16()).float().numpy()
    np.testing.assert_array_equal(out_b, np.swapaxes(ref_b, -1, -2))


@pytest.mark.parametrize("b,h,w,cin,cout,act", [(2, 4, 6, 72, 16, None), (1, 8, 8, 128, 64, "silu")])
def test_conv3x3_up2_matches_jax(b, h, w, cin, cout, act):
    r = _rng(12)
    x = r.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (r.standard_normal((cout, cin, 3, 3)) / np.sqrt(9 * cin)).astype(np.float32)
    bias = r.standard_normal(cout).astype(np.float32)
    assert jcf.supports_up2(x.shape, _hwio(wt).shape, 4)
    with jflags.override(pallas_interpret=True):
        ref = jcf.conv3x3_up2(jnp.asarray(x), jnp.asarray(_hwio(wt)), jnp.asarray(bias), act)
    out = tcf.conv3x3_up2(torch.from_numpy(x), _cl(wt), torch.from_numpy(bias), act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("asymmetric", [False, True], ids=["pad11", "pad01"])
def test_conv3x3_down2_matches_jax(asymmetric):
    r = _rng(13)
    x = r.standard_normal((2, 16, 8, 96)).astype(np.float32)
    wt = (r.standard_normal((40, 96, 3, 3)) / np.sqrt(9 * 96)).astype(np.float32)
    bias = r.standard_normal(40).astype(np.float32)
    assert jcf.supports_down2(x.shape, _hwio(wt).shape, 4)
    with jflags.override(pallas_interpret=True):
        ref = jcf.conv3x3_down2(jnp.asarray(x), jnp.asarray(_hwio(wt)), jnp.asarray(bias),
                                asymmetric=asymmetric)
    out = tcf.conv3x3_down2(torch.from_numpy(x), _cl(wt), torch.from_numpy(bias),
                            asymmetric=asymmetric)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize(
    "shape,groups,act,offset",
    [
        ((2, 8, 8, 64), 32, "silu", 0.0),
        ((1, 16, 8, 320), 32, None, 0.0),
        ((1, 8, 8, 128), 32, "silu", 300.0),  # |mean| >> std: the two-pass variance
    ],
)
def test_group_norm_kernel_plain_matches_jax(shape, groups, act, offset):
    r = _rng(14)
    x = (r.standard_normal(shape) * 0.5 + offset).astype(np.float32)
    gamma = r.standard_normal(shape[-1]).astype(np.float32)
    beta = r.standard_normal(shape[-1]).astype(np.float32)
    assert jgn.supports(shape, groups) and tgn.supports(shape, groups)
    with jflags.override(pallas_interpret=True):
        ref = jgn.fused_group_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                                   groups, 1e-6, act)
    out = tgn.fused_group_norm(torch.from_numpy(x), torch.from_numpy(gamma),
                               torch.from_numpy(beta), groups, 1e-6, act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# --------------------------------------------------------------- modules


def _random_params(init, *args, seed):
    tree = jax.eval_shape(init, *args)["params"]
    rng = np.random.default_rng(seed)

    def leaf(x):
        shape = np.shape(x)
        scale = 0.2 if len(shape) < 2 else 1.0 / np.sqrt(np.prod(shape[:-1]))
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return jax.tree.map(leaf, tree)


def _state_dict(convert, params, key):
    """One module's state dict through the converter's own helper."""
    out = from_jax._Out()
    convert(out, params, key)
    return dict(out)


def _count_calls(monkeypatch, targets):
    """Count the calls of each ``module.attr`` in ``{name: (module, attr)}``
    (the dispatchers look them up at call time), by name."""
    calls = Counter()
    for name, (module, attr) in targets.items():
        real = getattr(module, attr)

        def rec(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(module, attr, rec)
    return calls


def _count_fused(monkeypatch, *names):
    return _count_calls(monkeypatch, {n: (tcf, n) for n in names})


@pytest.mark.parametrize("cin,cout,temb", [(64, 64, 32), (72, 128, None)],
                         ids=["temb", "shortcut"])
def test_resnet_block_fused_matches_jax(monkeypatch, cin, cout, temb):
    """The whole-block fused form (two fused convs, the shortcut as skip).
    The parameter names and shapes are those of the unfused block, so
    ``tools/from_jax`` carries the JAX weights into it unchanged."""
    r = _rng(15)
    x = r.standard_normal((2, 8, 8, cin)).astype(np.float32)
    t = None if temb is None else r.standard_normal((2, temb)).astype(np.float32)
    jblock = jresnet.ResnetBlock2D(cout, use_time_emb=temb is not None, groups=8)
    params = _random_params(jblock.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            None if t is None else jnp.asarray(t), seed=16)
    with _on_tpu(), jflags.override(use_pallas_conv=True, use_fused_resnet=True,
                                    pallas_interpret=True):
        ref = jblock.apply({"params": params}, jnp.asarray(x),
                           None if t is None else jnp.asarray(t))
    block = tresnet.ResnetBlock2D(cin, cout, temb, groups=8).eval()
    sd = _state_dict(from_jax._resnet, params, "block")
    block.load_state_dict({k.removeprefix("block."): v for k, v in sd.items()}, strict=True)
    calls = _count_fused(monkeypatch, "conv3x3_fused")
    with torch.no_grad(), tflags.override(use_cuda_conv=True, use_fused_resnet=True):
        out = block(torch.from_numpy(x), None if t is None else torch.from_numpy(t))
    assert calls["conv3x3_fused"] == 2
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("kind", ["up", "down", "down_asymmetric"])
def test_resampling_layers_match_jax(monkeypatch, kind):
    r = _rng(17)
    x = r.standard_normal((2, 8, 8, 64)).astype(np.float32)
    if kind == "up":
        jmod, tmod = jresnet.Upsample2D(64), tresnet.Upsample2D(64)
        wrapper, field = "conv3x3_up2", "use_fused_up2"
    else:
        asym = kind == "down_asymmetric"
        jmod, tmod = jresnet.Downsample2D(64, asymmetric_pad=asym), \
            tresnet.Downsample2D(64, asymmetric_pad=asym)
        wrapper, field = "conv3x3_down2", "use_fused_down2"
    params = _random_params(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x), seed=18)
    with _on_tpu(), jflags.override(use_pallas_conv=True, pallas_interpret=True,
                                    **{field: True}):
        ref = jmod.apply({"params": params}, jnp.asarray(x))
    tmod.load_state_dict(_state_dict(from_jax._conv, params["conv"], "conv"), strict=True)
    calls = _count_fused(monkeypatch, wrapper)
    with torch.no_grad(), tflags.override(use_cuda_conv=True, **{field: True}):
        out = tmod(torch.from_numpy(x))
    assert calls[wrapper] == 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# Widths the gates admit (TINY_VAE's 16 and 32 channels reach no kernel).
WIDE_VAE = dataclasses.replace(JC.TINY_VAE, block_out_channels=(64, 64, 64, 64), norm_groups=32)


def test_vae_fused_contexts_match_jax(monkeypatch):
    """The decoder in the decode context (fused resnets, up2) and the
    encoder in the opt-in encode context (fused resnets, asymmetric down2),
    each against the JAX VAE under the same contexts."""
    r = _rng(19)
    img = r.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    jvae = JVAE(WIDE_VAE)
    params = _random_params(jvae.init, jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3)),
                            jax.random.PRNGKey(3), seed=20)
    with _on_tpu(), jflags.override(pallas_interpret=True):
        with jflags.override(use_pallas_conv=True):
            with jflags.override(**_jax_stage_overrides("encode")):
                mean, logvar = jvae.apply({"params": params}, jnp.asarray(img),
                                          method=jvae.encode_moments)
        with jflags.override(**_jax_stage_overrides("decode")):
            dec = jvae.apply({"params": params}, mean, method=jvae.decode)
    port = AutoencoderKL(TC.VAEConfig(**dataclasses.asdict(WIDE_VAE))).eval()
    port.load_state_dict(from_jax.vae_state_dict(params, WIDE_VAE), strict=True)
    calls = _count_fused(monkeypatch, "conv3x3_fused", "conv3x3_up2", "conv3x3_down2")
    with torch.no_grad():
        with tflags.override(use_cuda_conv=True), tflags.stage("encode"):
            tmean, tlogvar = port.encode_moments(torch.from_numpy(img))
        enc_calls = dict(calls)
        with tflags.stage("decode"):
            tdec = port.decode(torch.from_numpy(np.array(mean)))
    np.testing.assert_allclose(tmean.numpy(), np.asarray(mean), **TOL)
    np.testing.assert_allclose(tlogvar.numpy(), np.asarray(logvar), **TOL)
    np.testing.assert_allclose(tdec.numpy(), np.asarray(dec), **TOL)
    assert enc_calls == {"conv3x3_fused": 12, "conv3x3_down2": 3}
    assert calls["conv3x3_up2"] == 3 and calls["conv3x3_fused"] == 12 + 20


# ------------------------------------------------------------ the slice


@pytest.fixture(scope="module")
def editors(tiny_editor_f32):
    """The JAX tiny editor with its stages rebuilt under its accelerator's
    defaults (kernels interpreted), and the port's tiny editor with the
    same weights and noise; the JAX editor's stages are rebuilt again on
    teardown (the fixture is shared)."""
    jed, ted = carried_editors(tiny_editor_f32)
    yield jed, ted
    jed._rebuild_stages()


def test_tiny_editor_default_config_matches_jax_on_its_accelerator(editors):
    jed, ted = editors
    kw = dict(seed=7, guidance_scale=1.5, strength=0.8, num_inference_steps=4)
    with _on_tpu(), jflags.override(pallas_interpret=True):
        jed._rebuild_stages()
        ref = jed.edit(_img(0), "a red bicycle", **kw)
    out = ted.edit(_img(0), "a red bicycle", **kw)
    _assert_within_1_lsb(out, ref)


KERNEL_FUNCS = {  # the wrappers the dispatchers look up, by inventory name
    "conv3x3": (tconv3x3, "conv3x3"),
    "conv3x3_fused": (tcf, "conv3x3_fused"),
    "conv3x3_up2": (tcf, "conv3x3_up2"),
    "conv3x3_down2": (tcf, "conv3x3_down2"),
    "group_norm": (tgn, "fused_group_norm"),
    "group_norm_scale_shift": (tgn, "group_norm_scale_shift"),
    "flash_attention_d64": (tfa, "flash_attention"),
    "canny_prepare": (tcanny, "prepare"),
    "layer_norm": (tln, "fused_layer_norm"),
    "cross_attention": (tfa, "cross_attention"),
}


def count_prompt_encodes(monkeypatch) -> list:
    """The padded prompt count of each call of the prompt encoder (the CLIP
    towers' LayerNorms run once per call), in order."""
    counts = []
    real = tstages.encode_prompt

    def rec(mod, ids_1, ids_2):
        counts.append(ids_1.shape[0])
        return real(mod, ids_1, ids_2)

    monkeypatch.setattr(tstages, "encode_prompt", rec)
    return counts


def tiny_sites(control_res: int, encodes: list) -> Counter:
    """The tiny editor's sites of one edit, with the prompt encoder's calls
    ``encodes`` (:func:`count_prompt_encodes`)."""
    sites = inventory.edit_sites(TC.TINY_UNET, TC.TINY_CONTROLNET, TC.TINY_VAE, 64, batch=1,
                                 steps=3, control_res=control_res)
    for n in encodes:
        sites += inventory.prompt_sites(TC.TINY_TEXT_ENCODER, TC.TINY_TEXT_ENCODER_2, n)
    return sites


@pytest.mark.parametrize("config", [{}, {"use_fused_resnet": True, "use_cuda_groupnorm": True}],
                         ids=["default", "fused-resnet+groupnorm"])
def test_inventory_kernel_calls_equal_the_tiny_editors(editors, monkeypatch, config):
    """Each kernel wrapper is called as often as the inventory routes calls
    to it, in the default configuration and with the opt-in fusions (which
    move the UNet's resnets to the fused conv, their norms to the
    GroupNorm kernel's statistics launch and the other norms to the GroupNorm
    kernel); the LayerNorms of the prompt encoder's calls, if any, count too."""
    _, ted = editors
    calls = _count_calls(monkeypatch, KERNEL_FUNCS)
    encodes = count_prompt_encodes(monkeypatch)
    with tflags.override(**config):
        ted.edit(_img(5), "a boat", seed=1)
        expected = inventory.launches_by_kernel(inventory.kernel_calls(
            tiny_sites(ted._control_res, encodes)))
    assert {k: v for k, v in expected.items() if v} == dict(calls)
    assert calls["conv3x3"] and calls["conv3x3_up2"] and calls["conv3x3_down2"]
    assert calls["layer_norm"]
    if config:
        assert (calls["conv3x3_fused"] and calls["group_norm"]
                and calls["group_norm_scale_shift"])


def _jax_conv_inventory():
    shapes = set()
    for ucfg in (TC.SSD1B_UNET, TC.SDXL_UNET):
        for cn in (TC.SDXL_CONTROLNET_SMALL, TC.SDXL_CONTROLNET_FULL):
            shapes |= set(inventory.edit_sites(ucfg, cn, TC.SDXL_VAE, 1024))
    return shapes


def test_gates_match_jax_over_the_inventory():
    """Over every resnet, up2, down2 and GroupNorm call of the SSD-1B and
    SDXL edit paths at 1024², the port's gates admit what the JAX package's
    admit in bf16."""
    admitted = Counter()
    for _, op, key in sorted(_jax_conv_inventory(), key=str):
        if op == "resnet":
            n, h, w, cin, cout = key[:5]
            for ci, skip in ((cin, False), (cout, True)):
                port = tcf.supports_fused((n, h, w, ci), (cout, ci, 3, 3))
                assert port == jcf.supports_fused((n, h, w, ci), (3, 3, ci, cout), 2, skip), key
                admitted[op] += port
            for c in (cin, cout):
                assert tgn.supports((n, h, w, c), key[5]) == jgn.supports((n, h, w, c), key[5])
        elif op == "up2":
            n, h, w, cin, cout = key
            port = tcf.supports_up2((n, h, w, cin), (cout, cin, 3, 3))
            assert port == jcf.supports_up2((n, h, w, cin), (3, 3, cin, cout), 2), key
            admitted[op] += port
        elif op == "down2":
            n, h, w, cin, cout, _ = key
            port = tcf.supports_down2((n, h, w, cin), (cout, cin, 3, 3))
            assert port == jcf.supports_down2((n, h, w, cin), (3, 3, cin, cout), 2), key
            admitted[op] += port
        elif op == "gn":
            n, h, w, c, g, _ = key
            port = tgn.supports((n, h, w, c), g)
            assert port == jgn.supports((n, h, w, c), g), key
            admitted[op] += port
    assert admitted["resnet"] >= 20 and admitted["up2"] >= 5
    assert admitted["down2"] >= 6 and admitted["gn"] >= 6


@pytest.mark.parametrize("op", ["fused", "up2", "down2", "group_norm"])
def test_new_wrappers_never_take_the_plain_version_off_the_cpu(op):
    """A tensor off the CPU goes to the kernel or raises: here (meta
    tensors, no card, no nvcc) it must raise, never return a result."""
    x = torch.empty((1, 8, 8, 64), dtype=torch.bfloat16, device="meta")
    w = torch.empty((64, 64, 3, 3), dtype=torch.bfloat16,
                    device="meta").contiguous(memory_format=torch.channels_last)
    g = torch.empty(64, device="meta")
    call = {
        "fused": lambda: tcf.conv3x3_fused(x, w, prenorm=(g[None], g[None])),
        "up2": lambda: tcf.conv3x3_up2(x, w),
        "down2": lambda: tcf.conv3x3_down2(x, w, asymmetric=True),
        "group_norm": lambda: tgn.fused_group_norm(x, g, g, 32),
    }[op]
    before = (dict(tcf.launches), tgn.launches)
    with pytest.raises((RuntimeError, ValueError, TypeError, NotImplementedError)):
        call()
    assert (dict(tcf.launches), tgn.launches) == before
