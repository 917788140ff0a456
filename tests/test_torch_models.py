"""The port's models against the JAX package's, with weights carried across.

Each JAX model is initialised, its parameters are replaced by seeded numpy
normals (so zero-initialised convs and identity norms are exercised too),
``fastedit_tpu_torch.tools.from_jax`` turns them into a state dict, the
port's module loads it strictly, and both run the same numpy inputs in
fp32.  Tolerance: rtol = atol = 2e-4 (tests/test_golden_full_models.py).
Also checked: the port's state-dict keys and shapes equal the diffusers
inventory of the JAX package's ``tools/hf_inventory``, and ``from_jax``
round-trips through ``tools/hf_mapping.convert_*`` to the same JAX tree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastedit_tpu.models import configs as JC
from fastedit_tpu.models.clip import CLIPTextModel as JCLIP
from fastedit_tpu.models.controlnet import ControlNetModel as JControlNet
from fastedit_tpu.models.unet import UNet2DConditionModel as JUNet
from fastedit_tpu.models.vae import AutoencoderKL as JVAE
from fastedit_tpu.tools import hf_inventory, hf_mapping

from fastedit_tpu_torch.models import configs as TC
from fastedit_tpu_torch.models.clip import CLIPTextModel
from fastedit_tpu_torch.models.controlnet import ControlNetModel
from fastedit_tpu_torch.models.unet import UNet2DConditionModel
from fastedit_tpu_torch.models.vae import AutoencoderKL
from fastedit_tpu_torch.tools import from_jax

TOL = dict(rtol=2e-4, atol=2e-4)

# SSD-1B's topology at tiny width: no mid block, asymmetric up depths.
SSD1B_TINY = dataclasses.replace(
    JC.TINY_UNET,
    layers_per_block=2,
    down_transformer_layers=((0, 0), (1, 1), (1, 2)),
    mid_transformer_layers=None,
    up_transformer_layers=((1, 1, 2), (1, 0, 1), (0, 0, 0)),
)
UNET_CFGS = {"sdxl-tiny": JC.TINY_UNET, "ssd1b-tiny": SSD1B_TINY}


def _random_params(init, *args, seed):
    """Seeded normals in the shapes ``init`` would give (read with
    jax.eval_shape, so nothing is compiled): fan-in scaled for matrices."""
    tree = jax.eval_shape(init, *args)["params"]
    rng = np.random.default_rng(seed)

    def leaf(x):
        shape = np.shape(x)
        scale = 0.2 if len(shape) < 2 else 1.0 / np.sqrt(np.prod(shape[:-1]))
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return jax.tree.map(leaf, tree)


def _port(cls, cfg, sd):
    model = cls(cfg).eval()
    model.load_state_dict(sd, strict=True)
    return model


def _unet_inputs(cfg, seed, b=2, hw=8, seq=77):
    rng = np.random.default_rng(seed)
    pooled_dim = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
    return (
        rng.standard_normal((b, hw, hw, cfg.in_channels)).astype(np.float32),
        np.asarray([759.0, 279.0][:b], np.float32),
        rng.standard_normal((b, seq, cfg.cross_attention_dim)).astype(np.float32),
        rng.standard_normal((b, pooled_dim)).astype(np.float32),
        np.tile(np.asarray([[64, 64, 0, 0, 64, 64]], np.float32), (b, 1)),
    )


def _hf_unet_config(cfg):
    return {
        "in_channels": cfg.in_channels,
        "out_channels": cfg.out_channels,
        "block_out_channels": list(cfg.block_out_channels),
        "layers_per_block": cfg.layers_per_block,
        "transformer_layers_per_block": [list(d) for d in cfg.down_transformer_layers],
        "reverse_transformer_layers_per_block": [list(d) for d in cfg.up_transformer_layers],
        "mid_block_type": None if cfg.mid_transformer_layers is None else "UNetMidBlock2DCrossAttn",
        "down_block_types": ["CrossAttnDownBlock2D" if any(d) else "DownBlock2D"
                             for d in cfg.down_transformer_layers],
        "up_block_types": ["CrossAttnUpBlock2D" if any(d) else "UpBlock2D"
                           for d in cfg.up_transformer_layers],
        "num_attention_heads": list(cfg.num_attention_heads),
        "cross_attention_dim": cfg.cross_attention_dim,
        "projection_class_embeddings_input_dim": cfg.projection_class_embeddings_input_dim,
    }


@pytest.fixture(scope="module", params=list(UNET_CFGS), ids=list(UNET_CFGS))
def unet_pair(request):
    cfg = UNET_CFGS[request.param]
    x = [jnp.asarray(a) for a in _unet_inputs(cfg, 0)]
    params = _random_params(JUNet(cfg).init, jax.random.PRNGKey(0), *x, seed=1)
    return cfg, params


def test_unet_matches_jax(unet_pair):
    cfg, params = unet_pair
    inputs = _unet_inputs(cfg, 2)
    ref = JUNet(cfg).apply({"params": params}, *[jnp.asarray(a) for a in inputs])
    port = _port(UNet2DConditionModel, cfg, from_jax.unet_state_dict(params, cfg))
    with torch.no_grad():
        out = port(*[torch.from_numpy(a) for a in inputs])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_unet_state_dict_matches_diffusers_inventory(unet_pair):
    cfg, params = unet_pair
    port_sd = UNet2DConditionModel(cfg).state_dict()
    assert {k: tuple(v.shape) for k, v in from_jax.unet_state_dict(params, cfg).items()} == {
        k: tuple(v.shape) for k, v in port_sd.items()}
    # diffusers takes the mid block's depth from the last down block's
    if cfg.mid_transformer_layers is not None:
        cfg = dataclasses.replace(cfg, mid_transformer_layers=cfg.down_transformer_layers[-1][-1])
    inv = hf_inventory.unet_inventory(_hf_unet_config(cfg))
    port = UNet2DConditionModel(cfg)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == inv


def test_unet_from_jax_round_trips_through_hf_mapping(unet_pair):
    cfg, params = unet_pair
    sd = {k: v.numpy() for k, v in from_jax.unet_state_dict(params, cfg).items()}
    back = hf_mapping.convert_unet(sd, cfg, strict=True)
    jax.tree.map(np.testing.assert_array_equal, back, params)


@pytest.fixture(scope="module")
def controlnet_pair():
    cfg = JC.TINY_CONTROLNET
    x = [jnp.asarray(a) for a in _unet_inputs(cfg.unet, 3)]
    cond = jnp.zeros((2, 16, 16, 3))
    params = _random_params(JControlNet(cfg).init, jax.random.PRNGKey(1), *x, cond, seed=4)
    return cfg, params


@pytest.mark.parametrize("pre_embedded", [False, True], ids=["pixel-cond", "pre-embedded"])
def test_controlnet_matches_jax(controlnet_pair, pre_embedded):
    cfg, params = controlnet_pair
    inputs = _unet_inputs(cfg.unet, 5)
    rng = np.random.default_rng(6)
    cond = rng.random((2, 16, 16, 3)).astype(np.float32)
    jcn = JControlNet(cfg)
    port = _port(ControlNetModel, cfg, from_jax.controlnet_state_dict(params, cfg))
    if pre_embedded:  # the denoise loop's hoisted conditioning tower
        from fastedit_tpu.models.controlnet import ConditioningEmbedding

        jemb = ConditioningEmbedding(cfg.conditioning_embedding_channels,
                                     cfg.unet.block_out_channels[0])
        jcond = jemb.apply({"params": params["controlnet_cond_embedding"]}, jnp.asarray(cond))
        with torch.no_grad():
            tcond = port.controlnet_cond_embedding(torch.from_numpy(cond))
        np.testing.assert_allclose(tcond.numpy(), np.asarray(jcond), **TOL)
        cond = np.array(jcond)
    down, mid = jcn.apply({"params": params}, *[jnp.asarray(a) for a in inputs],
                          jnp.asarray(cond), 0.5, cond_pre_embedded=pre_embedded)
    with torch.no_grad():
        tdown, tmid = port(*[torch.from_numpy(a) for a in inputs], torch.from_numpy(cond),
                           0.5, cond_pre_embedded=pre_embedded)
    assert len(tdown) == len(down)
    for a, b in zip(tdown, down):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(tmid.numpy(), np.asarray(mid), **TOL)


def test_controlnet_round_trip_and_inventory(controlnet_pair):
    cfg, params = controlnet_pair
    sd = from_jax.controlnet_state_dict(params, cfg)
    back = hf_mapping.convert_controlnet({k: v.numpy() for k, v in sd.items()}, cfg, strict=True)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    # diffusers takes the mid block's depth from the last down block's
    ucfg = dataclasses.replace(
        cfg.unet, mid_transformer_layers=cfg.unet.down_transformer_layers[-1][-1])
    inv = hf_inventory.controlnet_inventory(dict(
        _hf_unet_config(ucfg),
        conditioning_embedding_out_channels=list(cfg.conditioning_embedding_channels),
    ))
    port = ControlNetModel(dataclasses.replace(cfg, unet=ucfg))
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == inv


@pytest.fixture(scope="module")
def vae_pair():
    cfg = JC.TINY_VAE
    params = _random_params(JVAE(cfg).init, jax.random.PRNGKey(2),
                            jnp.zeros((1, 32, 32, 3)), jax.random.PRNGKey(3), seed=7)
    return cfg, params


def test_vae_matches_jax(vae_pair):
    cfg, params = vae_pair
    rng = np.random.default_rng(8)
    img = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    jvae = JVAE(cfg)
    mean, logvar = jvae.apply({"params": params}, jnp.asarray(img), method=jvae.encode_moments)
    dec = jvae.apply({"params": params}, mean, method=jvae.decode)
    port = _port(AutoencoderKL, cfg, from_jax.vae_state_dict(params, cfg))
    with torch.no_grad():
        tmean, tlogvar = port.encode_moments(torch.from_numpy(img))
        tdec = port.decode(torch.from_numpy(np.array(mean)))
    np.testing.assert_allclose(tmean.numpy(), np.asarray(mean), **TOL)
    np.testing.assert_allclose(tlogvar.numpy(), np.asarray(logvar), **TOL)
    np.testing.assert_allclose(tdec.numpy(), np.asarray(dec), **TOL)
    # posterior sample with the same eps, logvar clipped to [-30, 20]
    eps = rng.standard_normal(np.shape(mean)).astype(np.float32)
    key_free = np.asarray(mean) + np.exp(0.5 * np.clip(np.asarray(logvar), -30, 20)) * eps
    z = AutoencoderKL.sample(tmean, tlogvar, torch.from_numpy(eps))
    np.testing.assert_allclose(z.numpy(), key_free, **TOL)


def test_vae_round_trip_and_inventory(vae_pair):
    cfg, params = vae_pair
    sd = from_jax.vae_state_dict(params, cfg)
    back = hf_mapping.convert_vae({k: v.numpy() for k, v in sd.items()}, cfg, strict=True)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    inv = hf_inventory.vae_inventory({
        "block_out_channels": list(cfg.block_out_channels),
        "layers_per_block": cfg.layers_per_block,
        "latent_channels": cfg.latent_channels,
        "in_channels": cfg.in_channels,
    })
    assert {k: tuple(v.shape) for k, v in AutoencoderKL(cfg).state_dict().items()} == inv


@pytest.mark.parametrize(
    "name,eos", [("TINY_TEXT_ENCODER", None), ("TINY_TEXT_ENCODER_2", None),
                 ("TINY_TEXT_ENCODER_2", 2)],
    ids=["tower1", "tower2-projected", "tower2-legacy-eos"],
)
def test_clip_text_matches_jax(name, eos):
    cfg = getattr(JC, name)
    if eos is not None:
        cfg = dataclasses.replace(cfg, eos_token_id=eos)
    rng = np.random.default_rng(9)
    ids = rng.integers(0, cfg.vocab_size - 1, (2, 77)).astype(np.int32)
    ids[0, 10] = ids[1, 40] = cfg.vocab_size - 1  # EOS / highest id
    ids[0, 11:] = ids[1, 41:] = 0
    jm = JCLIP(cfg)
    params = _random_params(jm.init, jax.random.PRNGKey(4), jnp.asarray(ids), seed=10)
    ref = jm.apply({"params": params}, jnp.asarray(ids))
    port = _port(CLIPTextModel, cfg, from_jax.clip_text_state_dict(params, cfg))
    with torch.no_grad():
        out = port(torch.from_numpy(ids).long())
    for field in ("last_hidden_state", "penultimate_hidden_state", "pooled_output"):
        np.testing.assert_allclose(getattr(out, field).numpy(),
                                   np.asarray(getattr(ref, field)), **TOL)
    back = hf_mapping.convert_clip_text(
        {k: v.numpy() for k, v in from_jax.clip_text_state_dict(params, cfg).items()},
        cfg, strict=True,
    )
    jax.tree.map(np.testing.assert_array_equal, back, params)
    assert repr(TC.TINY_TEXT_ENCODER) == repr(JC.TINY_TEXT_ENCODER)
