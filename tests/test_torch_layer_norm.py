"""LayerNorm (``fastedit_tpu_torch/ops/layer_norm.py``) on the CPU: its plain
version against the math the models ran before it and against the JAX
package's ``LayerNorm``, its gate, its registration with the build and the
inventory, and the dispatch.  The CUDA kernel is held against the plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerance against JAX: the golden rtol = atol = 2e-4 in fp32; in bf16 one
rounding more, to bf16 (rtol 2^-7): the two frameworks sum in other orders,
and a difference in the last fp32 bit can round to the neighbouring bf16.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fastedit_tpu.models.layers import LayerNorm as JLayerNorm

from fastedit_tpu_torch.models import configs as TC
from fastedit_tpu_torch.models.layers import LayerNorm, cast_model
from fastedit_tpu_torch.ops import build, flags
from fastedit_tpu_torch.ops import layer_norm as ln
from fastedit_tpu_torch.tools import inventory
from fastedit_tpu_torch.utils import profiling

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
JAX_DTYPES = {"bf16": jnp.bfloat16, "fp32": jnp.float32}
TOL = {"fp32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=2**-7, atol=2e-4)}


def _inputs(c: int, dtype: str, seed: int = 0, rows: tuple = (2, 7)):
    r = np.random.default_rng(seed + c)
    x = torch.from_numpy((r.standard_normal((*rows, c)) * 2 + 0.5).astype(np.float32))
    gamma = torch.from_numpy(r.standard_normal(c).astype(np.float32))
    beta = torch.from_numpy(r.standard_normal(c).astype(np.float32))
    return x.to(DTYPES[dtype]), gamma, beta


def _before(x, weight, bias, eps):
    """``models/layers.LayerNorm.forward`` as it was before the kernel."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("c", [32, 640, 768, 1280])
def test_plain_path_is_the_old_math_and_matches_jax(c, dtype, eps):
    """The module's output on the CPU (the dispatcher, then the wrapper's
    plain version) equals the old forward bit for bit, and the JAX
    package's LayerNorm within the golden tolerance."""
    x, gamma, beta = _inputs(c, dtype)
    module = LayerNorm(c, eps)
    with torch.no_grad():
        module.weight.copy_(gamma)
        module.bias.copy_(beta)
        out = module(x)
    assert out.dtype == x.dtype and out.shape == x.shape
    assert torch.equal(out, _before(x, gamma, beta, eps))
    assert torch.equal(ln.layer_norm_plain(x, gamma, beta, eps), out)
    jx = jnp.asarray(x.float().numpy()).astype(JAX_DTYPES[dtype])
    ref = JLayerNorm(eps=eps).apply(
        {"params": {"scale": jnp.asarray(gamma.numpy()), "bias": jnp.asarray(beta.numpy())}}, jx)
    assert ref.dtype == JAX_DTYPES[dtype]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               **TOL[dtype])


def test_plain_path_keeps_a_large_mean_two_pass():
    """|mean| >> std (300 against 0.02): the two-pass variance, which the
    kernel keeps too, stays within 1e-2 of fp64 (the fp32 mean's last bit,
    ~3e-5 against the std); the one-pass E[x^2] - E[x]^2 would cancel in
    fp32 and miss by far more."""
    x, gamma, beta = _inputs(640, "fp32")
    x = x * 0.01 + 300.0
    out = ln.layer_norm(x, gamma, beta)
    ref = _before(x.double(), gamma.double(), beta.double(), 1e-5)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-2, atol=1e-2)
    mean = x.mean(-1, keepdim=True)
    one_pass = (x - mean) * torch.rsqrt(x.square().mean(-1, keepdim=True) - mean**2 + 1e-5)
    miss = (one_pass * gamma + beta - ref.float()).abs().max()
    assert not miss <= 1e-2  # NaN where E[x^2] - E[x]^2 went negative


@pytest.mark.parametrize("c,dtype,admitted", [
    (640, torch.bfloat16, True), (1280, torch.bfloat16, True), (768, torch.float32, True),
    (1280, torch.float32, True), (32, torch.bfloat16, True), (8, torch.float32, True),
    (2048, torch.float32, True), (2048, torch.bfloat16, True),
    (2056, torch.bfloat16, False), (4096, torch.float32, False), (12, torch.bfloat16, False),
    (636, torch.float32, False), (0, torch.bfloat16, False), (640, torch.float16, False),
    (640, torch.float64, False),
])
def test_supports_takes_whole_vectors_up_to_the_widest_row(c, dtype, admitted):
    """Rows of a multiple of 8 values up to 2048, bf16 or fp32: every
    LayerNorm of the port's models, the tiny ones included."""
    assert ln.supports(c, dtype) is admitted


def test_every_models_layer_norm_is_inside_the_gate():
    widths = {TC.SSD1B_UNET.block_out_channels[i] for i, depth in
              enumerate(TC.SSD1B_UNET.down_transformer_layers) if any(depth)}
    widths |= {cfg.hidden_size for cfg in (TC.SDXL_TEXT_ENCODER, TC.SDXL_TEXT_ENCODER_2,
                                             TC.TINY_TEXT_ENCODER, TC.TINY_TEXT_ENCODER_2)}
    assert widths >= {640, 1280, 768, 32}
    assert all(ln.supports(c, dt) for c in widths for dt in DTYPES.values())


def test_the_build_registers_both_entries():
    """``ops/build.py`` loads ``csrc/layer_norm.cu`` with the bf16 and fp32
    entries: x, weight, bias, out, rows, C, eps, stream."""
    entries = build.KERNELS["layer_norm"]
    assert set(entries) == {"layer_norm_bf16", "layer_norm_f32"}
    for argtypes in entries.values():
        assert argtypes == [build._P] * 4 + [build._I] * 2 + [build.ctypes.c_float, build._P]
    assert build.sources("layer_norm") == [build.CSRC / "layer_norm.cu"]


def test_inventory_counts_and_resets_layer_norm_launches(monkeypatch):
    assert "layer_norm" in inventory.BF16_KERNELS
    assert {"layer_norm", "layer_norm_f32"} <= set(inventory.KERNELS)
    monkeypatch.setattr(ln, "launches", 5)
    monkeypatch.setattr(ln, "launches_f32", 3)
    counts = inventory.launch_counts()
    assert counts["layer_norm"] == 5 and counts["layer_norm_f32"] == 3
    inventory.reset_launch_counts()
    assert ln.launches == ln.launches_f32 == 0


def test_inventory_routes_every_transformer_and_clip_layer_norm():
    """SSD-1B at 1024²: three LayerNorms in each of 8 blocks at 4096 tokens x
    640 and 26 at 1024 x 1280, 102 a UNet pass, 306 an edit of 3 steps (the
    small ControlNet has no transformer block); the prompt encoder's call,
    2 x 12 + 1 (CLIP ViT-L) and 2 x 32 + 1 (OpenCLIP bigG)."""
    sites = inventory.edit_sites(TC.SSD1B_UNET, TC.SDXL_CONTROLNET_SMALL, TC.SDXL_VAE, 1024,
                                 batch=4, steps=3)
    assert {key: n for (_, op, key), n in sites.items() if op == "ln"} == {
        (8, 4096, 640): 3 * 8 * 3, (8, 1024, 1280): 3 * 26 * 3}
    for dtype, name in ((torch.bfloat16, "layer_norm"), (torch.float32, "layer_norm_f32")):
        assert inventory.launches_by_kernel(inventory.kernel_calls(sites, dtype))[name] == 306
    prompts = inventory.prompt_sites(TC.SDXL_TEXT_ENCODER, TC.SDXL_TEXT_ENCODER_2, 4)
    assert dict(prompts) == {("prompts", "ln", (4, 77, 768)): 25,
                             ("prompts", "ln", (4, 77, 1280)): 65}
    assert inventory.kernel_calls(prompts) == {("layer_norm", (4, 77, 768)): 25,
                                               ("layer_norm", (4, 77, 1280)): 65}
    assert inventory.route("ln", (1, 5, 12)) == []


def test_dispatch_on_the_cpu(monkeypatch):
    """Inside the gate the dispatcher calls the wrapper (which runs the plain
    version on the CPU), or the plain version under ``plain_versions``;
    outside it the plain version, counted only for a tensor on the card."""
    called = []
    real = ln.fused_layer_norm
    monkeypatch.setattr(ln, "fused_layer_norm", lambda *a: called.append(a) or real(*a))
    x, gamma, beta = _inputs(64, "bf16")
    before = profiling.counters().get("layer_norm.plain_on_card", 0)
    assert torch.equal(ln.layer_norm(x, gamma, beta), _before(x, gamma, beta, 1e-5))
    assert len(called) == 1
    with flags.override(plain_versions=True):
        ln.layer_norm(x, gamma, beta)
    assert len(called) == 1
    x12 = torch.randn(3, 12)
    out = ln.layer_norm(x12, torch.ones(12), torch.zeros(12))
    assert torch.equal(out, _before(x12, torch.ones(12), torch.zeros(12), 1e-5))
    assert len(called) == 1
    assert profiling.counters().get("layer_norm.plain_on_card", 0) == before


def test_the_wrapper_takes_bf16_or_fp32_only():
    x = torch.randn(2, 64, dtype=torch.float16)
    with pytest.raises(TypeError, match="layer_norm"):
        ln.fused_layer_norm(x, torch.ones(64), torch.zeros(64))


def test_the_module_keeps_its_parameters_and_state_dict_names():
    """``weight`` and ``bias`` in fp32 after ``cast_model`` to bf16, as the
    JAX package keeps its norm parameters."""
    model = torch.nn.Sequential(torch.nn.Linear(32, 32), LayerNorm(32))
    assert set(model.state_dict()) == {"0.weight", "0.bias", "1.weight", "1.bias"}
    cast_model(model, "cpu", torch.bfloat16)
    assert model[0].weight.dtype == torch.bfloat16
    assert model[1].weight.dtype == model[1].bias.dtype == torch.float32
    out = model(torch.randn(3, 32, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16
