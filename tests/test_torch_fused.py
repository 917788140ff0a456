"""The port's fused conv kernels, GroupNorm kernel and kernel plan against
the JAX package's.

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

import contextlib
import dataclasses
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
from fastedit_tpu.ops import conv3x3 as jconv3x3
from fastedit_tpu.ops import conv_fused as jcf
from fastedit_tpu.ops import flags as jflags
from fastedit_tpu.ops import flash_attention as jfa
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


# ------------------------------------------------------------------ plan


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


def with_the_encoder_on_the_kernels(sites: Counter) -> Counter:
    """``sites`` with the VAE encoder's routed as the JAX package routes them
    with its conv kernel turned on in the encoder (``use_pallas_conv=True``):
    resnets and convs as in the decoder (the conv and fused resnet kernels),
    the stride-2 convs as in the denoise loop.  For the shape enumerations,
    which cover the kernels at those shapes too."""
    out = Counter()
    for (stage, op, key), c in sites.items():
        if stage == "encode":
            stage = "denoise" if op == "down2" else "decode"
        out[(stage, op, key)] += c
    return out


def test_stage_scopes_and_restores_the_flags():
    """A stage sets the thread's plan for its body and restores the one
    outside it (none: no conv kernel), whatever the body raises; the flags
    stay as they were."""
    x, w = (1, 8, 8, 64), (64, 64, 3, 3)
    conv_kernels = lambda: {k for k in tflags.CONV_KERNELS  # noqa: E731
                            if tflags.takes(k, x, w)}
    assert tflags.current_stage() is None and not conv_kernels()
    with tflags.stage("decode"):
        assert conv_kernels() == {"conv3x3", "conv3x3_fused", "conv3x3_up2"}
        with tflags.stage("encode"):
            assert tflags.current_stage() == "encode" and not conv_kernels()
        assert tflags.current_stage() == "decode"
    with tflags.stage("denoise"):
        assert conv_kernels() == {"conv3x3", "conv3x3_up2", "conv3x3_down2"}
    with pytest.raises(RuntimeError), tflags.stage("denoise"):
        raise RuntimeError
    assert tflags.current_stage() is None and not conv_kernels()
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
    """The whole-block fused form (two fused convs, the shortcut as skip), in
    the stage whose plan has it (the decoder's).  The parameter names and
    shapes are those of the unfused block, so ``tools/from_jax`` carries the
    JAX weights into it unchanged."""
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
    with torch.no_grad(), tflags.stage("decode"):
        out = block(torch.from_numpy(x), None if t is None else torch.from_numpy(t))
    assert calls["conv3x3_fused"] == 2
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("kind", ["up", "down", "down_asymmetric"])
def test_resampling_layers_match_jax(monkeypatch, kind):
    """Each resampling layer on its kernel, in the denoise loop, whose plan
    has both (the asymmetric stride-2 form is the VAE encoder's, whose plan
    has no conv kernel: its gate is the same)."""
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
    with torch.no_grad(), tflags.stage("denoise"):
        out = tmod(torch.from_numpy(x))
    assert calls[wrapper] == 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# Widths the gates admit (TINY_VAE's 16 and 32 channels reach no kernel).
WIDE_VAE = dataclasses.replace(JC.TINY_VAE, block_out_channels=(64, 64, 64, 64), norm_groups=32)


def test_vae_fused_contexts_match_jax(monkeypatch):
    """The decoder in the decode stage (fused resnets, up2) and the encoder
    with the JAX package's opt-in encode context as its plan row (fused
    resnets, asymmetric down2: what trying the encoder on the kernels would
    run), each against the JAX VAE under the same contexts."""
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
    monkeypatch.setitem(tflags.PLAN, "encode", frozenset({"conv3x3", "conv3x3_fused",
                                                          "conv3x3_down2"}))
    with torch.no_grad():
        with tflags.stage("encode"):
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


def tiny_sites(control_res: int, encodes: list, cfg_guidance: bool = True) -> Counter:
    """The tiny editor's sites of one edit, with the prompt encoder's calls
    ``encodes`` (:func:`count_prompt_encodes`)."""
    sites = inventory.edit_sites(TC.TINY_UNET, TC.TINY_CONTROLNET, TC.TINY_VAE, 64, batch=1,
                                 steps=3, cfg_guidance=cfg_guidance, control_res=control_res)
    for n in encodes:
        sites += inventory.prompt_sites(TC.TINY_TEXT_ENCODER, TC.TINY_TEXT_ENCODER_2, n)
    return sites


@pytest.mark.parametrize("guidance", [None, 1.0], ids=["default", "guidance-1"])
def test_inventory_kernel_calls_equal_the_tiny_editors(editors, monkeypatch, guidance):
    """Each kernel wrapper is called as often as the inventory routes calls
    to it, at the default guidance (CFG: the denoise loop at batch 2) and at
    guidance 1.0 (no CFG: batch 1); the LayerNorms of the prompt encoder's
    calls, if any, count too."""
    _, ted = editors
    calls = _count_calls(monkeypatch, KERNEL_FUNCS)
    encodes = count_prompt_encodes(monkeypatch)
    kw = {} if guidance is None else dict(guidance_scale=guidance)
    ted.edit(_img(5), "a boat", seed=1, **kw)
    expected = inventory.launches_by_kernel(inventory.kernel_calls(
        tiny_sites(ted._control_res, encodes, cfg_guidance=guidance is None)))
    assert {k: v for k, v in expected.items() if v} == dict(calls)
    assert calls["conv3x3"] and calls["conv3x3_up2"] and calls["conv3x3_down2"]
    assert calls["layer_norm"]


def jax_route(op, key, itemsize):
    """The JAX package's dispatch of one site under its current flags, as
    (kernel, shape) calls in the inventory's names and keys (GroupNorm left
    out: its kernel is opt-in there)."""
    def conv(key):
        n, h, w, cin, cout = key
        if jflags.use_pallas_conv() and jconv3x3.supports((n, h, w, cin), (3, 3, cin, cout),
                                                          itemsize):
            return [("conv3x3", key)]
        return []

    if op == "conv":
        return conv(key)
    if op == "resnet":
        n, h, w, cin, cout, _, temb = key
        if (jflags.use_fused_resnet()
                and jcf.supports_fused((n, h, w, cin), (3, 3, cin, cout), itemsize)
                and jcf.supports_fused((n, h, w, cout), (3, 3, cout, cout), itemsize, True)):
            return [("conv3x3_fused", (n, h, w, cin, cout, temb, False)),
                    ("conv3x3_fused", (n, h, w, cout, cout, False, True))]
        return conv((n, h, w, cin, cout)) + conv((n, h, w, cout, cout))
    if op == "up2":
        n, h, w, cin, cout = key
        if jflags.use_fused_up2() and jcf.supports_up2((n, h, w, cin), (3, 3, cin, cout),
                                                       itemsize):
            return [("conv3x3_up2", key)]
        return conv((n, 2 * h, 2 * w, cin, cout))
    if op == "down2":
        n, h, w, cin, cout, _ = key
        if jflags.use_fused_down2() and jcf.supports_down2((n, h, w, cin), (3, 3, cin, cout),
                                                           itemsize):
            return [("conv3x3_down2", key)]
        return []
    if op == "attn":
        b, sq, skv, heads, d = key
        if jflags.use_pallas_attention() and jfa.supports((b, sq, heads, d), skv):
            # D = 64 stays on the head-packed kernel (K2) at item size 4
            assert jfa.supports_packed((b, sq, heads, d), skv, itemsize) == (d == 64)
            return [(f"flash_attention_d{d}", key)]
        return []
    return []


def _jax_groupnorm_route(op, key, route):
    """The GroupNorm calls of one site with the JAX package's GroupNorm kernel
    on (the port's departure): the statistics of each fused conv's prologue
    (``route`` is the site's conv calls), or each norm, where the JAX gate
    admits it."""
    def gn(kernel, key):
        n, h, w, c, groups = key[:5]
        return [(kernel, key)] if jgn.supports((n, h, w, c), groups) else []

    if op == "resnet":
        n, h, w, cin, cout, groups, _ = key
        if route and route[0][0] == "conv3x3_fused":
            return (gn("group_norm_scale_shift", (n, h, w, cin, groups))
                    + gn("group_norm_scale_shift", (n, h, w, cout, groups)))
        return (gn("group_norm", (n, h, w, cin, groups, "silu"))
                + gn("group_norm", (n, h, w, cout, groups, "silu")))
    return gn("group_norm", key) if op == "gn" else []


def _gates_match_jax(op, key):
    """The port's gates admit what the JAX package's admit in bf16, whatever
    the site's stage: both convs of a resnet on the fused kernel (the second
    with its skip), their norms, an upsampler, a stride-2 conv, a norm."""
    if op == "resnet":
        n, h, w, cin, cout, groups = key[:6]
        for ci, skip in ((cin, False), (cout, True)):
            assert tcf.supports_fused((n, h, w, ci), (cout, ci, 3, 3)) == \
                jcf.supports_fused((n, h, w, ci), (3, 3, ci, cout), 2, skip)
            assert tgn.supports((n, h, w, ci), groups) == jgn.supports((n, h, w, ci), groups)
    elif op == "up2":
        n, h, w, cin, cout = key
        assert tcf.supports_up2((n, h, w, cin), (cout, cin, 3, 3)) == \
            jcf.supports_up2((n, h, w, cin), (3, 3, cin, cout), 2)
    elif op == "down2":
        n, h, w, cin, cout, _ = key
        assert tcf.supports_down2((n, h, w, cin), (cout, cin, 3, 3)) == \
            jcf.supports_down2((n, h, w, cin), (3, 3, cin, cout), 2)
    elif op == "gn":
        n, h, w, c, g, _ = key
        assert tgn.supports((n, h, w, c), g) == jgn.supports((n, h, w, c), g)


def _sites(unet, cn, vae, resolution):
    return set(inventory.edit_sites(unet, cn, vae, resolution))


# Every distinct (stage, op, key) of the SSD-1B and SDXL edits at 1024² (either
# ControlNet: the same sites), batch 1, and the tiny model's at 64² besides.
MAIN_SITES = (_sites(TC.SSD1B_UNET, TC.SDXL_CONTROLNET_SMALL, TC.SDXL_VAE, 1024)
              | _sites(TC.SDXL_UNET, TC.SDXL_CONTROLNET_SMALL, TC.SDXL_VAE, 1024))
PLAN_SITES = sorted(MAIN_SITES | _sites(TC.TINY_UNET, TC.TINY_CONTROLNET, TC.TINY_VAE, 64),
                    key=str)


@contextlib.contextmanager
def _without_the_tpu_tile_budget():
    """The JAX package's conv gates without their TPU tile pickers, whose VMEM
    budget and tile rows the port's gates do not carry over
    (``ops/conv3x3.supports``): the tiny model's 2x2 and 4x4 levels, which
    no picker tiles, are admitted as the port admits them."""
    tile = lambda *args: (1, 128)  # noqa: E731
    with mock.patch.object(jconv3x3, "_pick_tiles", tile), \
            mock.patch.multiple(jcf, _pick_tiles_fused=tile, _pick_tiles_up2=tile,
                                _pick_tiles_down2=tile):
        yield


@pytest.mark.parametrize("site", PLAN_SITES, ids=lambda s: "-".join((*s[:2], *map(str, s[2]))))
def test_the_plan_routes_each_site_as_jax_on_its_accelerator(site):
    """The plan sends each site to the kernels the JAX package's defaults on
    its accelerator send it to, in bf16, but for the stated departures: the
    GroupNorm kernel and its statistics launch on, cross-attention to the
    text tokens on its kernel, and the port's own LayerNorm and Canny
    kernels; and each of the site's gates admits what the JAX gate admits.
    On the SSD-1B and SDXL edit paths the JAX gates are read as they are
    (their TPU tile budget admits every bf16 call there); on the tiny
    model's other sites, without their tile pickers."""
    stage, op, key = site
    budget = (contextlib.nullcontext() if site in MAIN_SITES
              else _without_the_tpu_tile_budget())
    with _on_tpu(), budget, contextlib.ExitStack() as ctx:
        if stage in tflags.STAGES:
            ctx.enter_context(tflags.stage(stage))
            ctx.enter_context(jflags.override(**_jax_stage_overrides(stage)))
        port = inventory.route(op, key)
        jax_calls = jax_route(op, key, 2)
        _gates_match_jax(op, key)
    if op == "attn" and not jax_calls:  # the JAX package: XLA at any item size
        b, sq, skv, heads, d = key
        if tfa.supports_cross((b, sq, heads, d), skv, torch.bfloat16):
            jax_calls = [("cross_attention", key)]
    elif op == "ln":  # the JAX package: XLA
        jax_calls = [("layer_norm", key)] if tln.supports(key[-1]) else []
    elif op == "canny":  # the JAX package: XLA
        jax_calls = [("canny_prepare", key)]
    assert [c for c in port if not c[0].startswith("group_norm")] == jax_calls
    assert [c for c in port if c[0].startswith("group_norm")] == \
        _jax_groupnorm_route(op, key, jax_calls)


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
