"""Checkpoint loading in the port against the JAX package's, on the CPU.

* The port's safetensors reader and writer (``utils/safetensors_io.py``)
  against the installed ``safetensors`` in both directions, F32 / F16 / BF16
  (and I64, which transformers' text encoders carry), a channels-last conv
  weight included: equal tensors, bit for bit.
* Config JSON (nested ``ControlNetConfig``), ``hf_config`` on the vendored
  public configs and the ``--expect`` drift check against the JAX package's.
* LoRA fusion in its four dialects against the JAX package's, bit for bit
  in fp32.
* Both converters on one tiny HF-style snapshot (SSD-1B's topology at tiny
  width, fp16, written by ``chip_smoke.write_hf_snapshot``, the function
  phase 6 runs on the card): the same config JSON and, tensor for tensor,
  the same ``weights.safetensors``, each package reading the other's.
* ``FastEditor("ssd-1b", checkpoint_dir=..., device="cpu")`` on the JAX
  converter's fp32 directory: every parameter equals ``from_jax`` of the
  JAX loader's tree, and the UNet, VAE and both CLIP towers match the JAX
  modules on it at rtol = atol = 2e-4 (the repo's golden tolerance).
* The loader's errors and the editor's log note for ``enable_cpu_offload``.
"""

import dataclasses
import json
import logging
import math
import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors import numpy as st_numpy
from safetensors import torch as st_torch

from fastedit_tpu.models import configs as JC
from fastedit_tpu.models.clip import CLIPTextModel as JCLIP
from fastedit_tpu.models.unet import UNet2DConditionModel as JUNet
from fastedit_tpu.models.vae import AutoencoderKL as JVAE
from fastedit_tpu.text.tokenizer import CLIPTokenizer as JTokenizer
from fastedit_tpu.tools import convert_checkpoint as jconvert
from fastedit_tpu.tools import hf_config as jhf
from fastedit_tpu.tools import lora as jlora
from fastedit_tpu.utils import checkpoint as jckpt

import chip_smoke
from fastedit_tpu_torch import FastEditor
from fastedit_tpu_torch.models import configs as TC
from fastedit_tpu_torch.models.clip import CLIPTextModel
from fastedit_tpu_torch.models.controlnet import ControlNetModel
from fastedit_tpu_torch.models.unet import UNet2DConditionModel
from fastedit_tpu_torch.models.vae import AutoencoderKL
from fastedit_tpu_torch.tools import convert_checkpoint as tconvert
from fastedit_tpu_torch.tools import from_jax, hf_vendored
from fastedit_tpu_torch.tools import hf_config as thf
from fastedit_tpu_torch.tools import lora as tlora
from fastedit_tpu_torch.utils import checkpoint as tckpt
from fastedit_tpu_torch.utils import safetensors_io

TOL = dict(rtol=2e-4, atol=2e-4)
DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}
COMPONENTS = ("unet", "controlnet", "vae", "text_encoder", "text_encoder_2")

# ------------------------------------------------------------ safetensors


def _tensors(dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    conv = (torch.randn((8, 5, 3, 3), generator=gen) * 3).to(dtype)
    return {
        "conv.weight": conv.contiguous(memory_format=torch.channels_last),
        "linear.weight": torch.randn((7, 5), generator=gen).to(dtype).t(),  # a view
        "norm.bias": torch.randn(3, generator=gen).to(dtype),
        "scalar": torch.tensor(2.5, dtype=dtype),
        "empty": torch.zeros((0, 4), dtype=dtype),
        "odd": torch.randn(5, generator=gen).to(dtype),  # an odd byte count before others
        "position_ids": torch.arange(77).view(1, 77),  # I64
    }


def _assert_same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", list(DTYPES))
def test_port_writer_read_by_safetensors(tmp_path, name):
    tensors = _tensors(DTYPES[name])
    assert not tensors["conv.weight"].is_contiguous()
    path = str(tmp_path / "t.safetensors")
    safetensors_io.save_file(tensors, path)
    _assert_same(st_torch.load_file(path), tensors)
    if name != "BF16":
        loaded = st_numpy.load_file(path)
        for k, v in tensors.items():
            np.testing.assert_array_equal(loaded[k], v.numpy())


@pytest.mark.parametrize("name", list(DTYPES))
def test_port_reader_reads_safetensors(tmp_path, name):
    tensors = _tensors(DTYPES[name], seed=1)
    path = str(tmp_path / "t.safetensors")
    st_torch.save_file({k: v.contiguous() for k, v in tensors.items()}, path,
                       metadata={"format": "pt"})  # as HF's files carry
    _assert_same(safetensors_io.load_file(path), tensors)
    # numpy's writer (which writes an array's buffer as it lies: C order
    # first); bf16 as ml_dtypes, which the port never needs
    np_dtype = {"F32": np.float32, "F16": np.float16, "BF16": ml_dtypes.bfloat16}[name]
    arrays = {k: np.ascontiguousarray(v.float().numpy().astype(np_dtype))
              for k, v in tensors.items() if v.is_floating_point()}
    st_numpy.save_file(arrays, path)
    back = safetensors_io.load_file(path)
    for k, v in arrays.items():
        assert back[k].dtype == DTYPES[name]
        np.testing.assert_array_equal(back[k].float().numpy(), v.astype(np.float32))


def test_reader_rejects_a_truncated_file(tmp_path):
    path = tmp_path / "t.safetensors"
    safetensors_io.save_file(_tensors(torch.float32), str(path))
    path.write_bytes(path.read_bytes()[:-4])
    with pytest.raises(ValueError):
        safetensors_io.load_file(str(path))


def test_save_params_writes_channels_last_weights_contiguous(tmp_path):
    """The trap the JAX package hit: a writer that dumps a non-contiguous
    tensor's buffer corrupts it.  Both packages' loaders read it right."""
    w = torch.randn(16, 8, 3, 3).contiguous(memory_format=torch.channels_last)
    tree = {"conv": {"kernel": w, "bias": torch.randn(16)}}
    tckpt.save_params(str(tmp_path / "m"), tree, dtype=torch.bfloat16)
    back = tckpt.load_params(str(tmp_path / "m"))
    assert torch.equal(back["conv"]["kernel"], w.bfloat16())
    jback = jckpt.load_params(str(tmp_path / "m"), dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(jback["conv"]["kernel"]), w.bfloat16().float().numpy())


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("name", ["TINY_CONTROLNET", "SDXL_CONTROLNET_SMALL", "SSD1B_UNET"])
def test_config_json_matches_jax_and_nests(tmp_path, name):
    tcfg, jcfg = getattr(TC, name), getattr(JC, name)
    cls = type(tcfg)
    tckpt.save_config(str(tmp_path / "port"), tcfg)
    jckpt.save_config(str(tmp_path / "jax"), jcfg)
    assert (tmp_path / "port" / "config.json").read_text() == (
        tmp_path / "jax" / "config.json").read_text()
    loaded = tckpt.load_config(str(tmp_path / "jax"), cls)
    assert loaded == tcfg
    if cls is TC.ControlNetConfig:
        assert isinstance(loaded.unet, TC.UNetConfig)


VENDORED = {  # name in tools/hf_vendored.py -> what it configures
    "SDXL_UNET_CONFIG": "unet", "SSD1B_UNET_CONFIG": "unet",
    "CONTROLNET_FULL_CONFIG": "controlnet", "CONTROLNET_SMALL_CONFIG": "controlnet",
    "VAE_CONFIG": "vae", "CLIP_VIT_L_TEXT_CONFIG": "text", "CLIP_BIGG_TEXT_CONFIG": "text",
}


def _derive(hf, kind, cfg):
    if kind == "text":
        return hf.clip_text_config_from_hf(cfg, with_projection=True)
    return getattr(hf, f"{kind}_config_from_hf")(cfg)


def test_vendored_configs_are_the_jax_packages():
    from fastedit_tpu.tools import hf_vendored as jvendored

    names = [k for k in vars(jvendored) if k.isupper()]
    assert names and names == [k for k in vars(hf_vendored) if k.isupper()]
    for name in names:
        assert getattr(hf_vendored, name) == getattr(jvendored, name), name


@pytest.mark.parametrize("name", list(VENDORED))
def test_hf_config_matches_jax(name):
    kind, cfg = VENDORED[name], getattr(hf_vendored, name)
    assert dataclasses.asdict(_derive(thf, kind, cfg)) == dataclasses.asdict(
        _derive(jhf, kind, cfg))


@pytest.mark.parametrize("expect,kind,cfg", [
    ("ssd-1b", "unet", hf_vendored.SSD1B_UNET_CONFIG),
    ("sdxl", "unet", hf_vendored.SDXL_UNET_CONFIG),
    ("controlnet-small", "controlnet", hf_vendored.CONTROLNET_SMALL_CONFIG),
    ("controlnet-full", "controlnet", hf_vendored.CONTROLNET_FULL_CONFIG),
    ("vae", "vae", hf_vendored.VAE_CONFIG),
])
def test_expect_passes_the_documented_configs_and_fails_a_drift(expect, kind, cfg):
    tconvert._assert_expected_config(expect, kind, _derive(thf, kind, cfg))
    drift = dict(cfg, norm_num_groups=16)  # a planted drift
    with pytest.raises(SystemExit) as port:
        tconvert._assert_expected_config(expect, kind, _derive(thf, kind, drift))
    with pytest.raises(SystemExit) as ref:
        jconvert._assert_expected_config(expect, kind, _derive(jhf, kind, drift))
    assert "DRIFTS" in str(port.value) and "norm_groups" in str(port.value)
    assert str(port.value) == str(ref.value)
    with pytest.raises(SystemExit):  # another kind
        tconvert._assert_expected_config(expect, "text_encoder", _derive(thf, kind, cfg))


# ------------------------------------------------------------------- LoRA

LORA_DIALECTS = {
    "peft": ("unet.{m}.lora_A.weight", "unet.{m}.lora_B.weight"),
    "diffusers": ("unet.{m}.lora.down.weight", "unet.{m}.lora.up.weight"),
    "lora_linear_layer": ("{m}.lora_linear_layer.down.weight", "{m}.lora_linear_layer.up.weight"),
    "kohya": ("lora_unet_{k}.lora_down.weight", "lora_unet_{k}.lora_up.weight"),
}


@pytest.mark.parametrize("base_dtype", ["float32", "float16"])
@pytest.mark.parametrize("dialect", list(LORA_DIALECTS))
def test_lora_fusion_matches_jax(dialect, base_dtype):
    rng = np.random.default_rng(3)
    modules = {  # module -> (weight shape); a 1x1 conv LoRA too
        "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q": (24, 16),
        "up_blocks.0.attentions.2.transformer_blocks.1.attn2.to_out.0": (16, 24),
        "down_blocks.1.attentions.0.proj_in": (16, 16, 1, 1),
    }
    base = {f"{m}.weight": rng.standard_normal(s).astype(base_dtype) for m, s in modules.items()}
    base["conv_in.weight"] = rng.standard_normal((4, 4, 3, 3)).astype(base_dtype)
    lora = {}
    for i, (m, shape) in enumerate(modules.items()):
        rank = 4 + i
        down_key, up_key = (f.format(m=m, k=m.replace(".", "_")) for f in LORA_DIALECTS[dialect])
        lora[down_key] = rng.standard_normal((rank, shape[1])).astype(np.float32)
        lora[up_key] = rng.standard_normal((shape[0], rank)).astype(np.float32)
        if dialect == "kohya":
            lora[down_key.replace(".lora_down.weight", ".alpha")] = np.float32(2.0 + i)
    jfused, jn = jlora.fuse_lora_into_state_dict(base, lora)
    tfused, tn = tlora.fuse_lora_into_state_dict(
        {k: torch.from_numpy(v) for k, v in base.items()},
        {k: torch.from_numpy(np.asarray(v)) for k, v in lora.items()})
    assert jn == tn == len(modules)
    for k, v in jfused.items():
        assert tfused[k].dtype == getattr(torch, base_dtype)
        np.testing.assert_array_equal(tfused[k].numpy(), v)
        if k != "conv_in.weight":
            assert not np.array_equal(v, base[k])


def test_lora_fusion_is_strict_on_a_missing_module():
    lora = {"unet.nowhere.lora_A.weight": torch.ones(2, 3), "unet.nowhere.lora_B.weight":
            torch.ones(4, 2)}
    with pytest.raises(KeyError):
        tlora.fuse_lora_into_state_dict({"other.weight": torch.zeros(4, 3)}, lora)


# ------------------------------------------------ converters and the loader

# SSD-1B's topology at tiny width (no mid block, asymmetric up depths), the
# small ControlNet's (conv only), the SDXL VAE's and both CLIP towers'.
_UNET_COMMON = {
    "in_channels": 4, "out_channels": 4, "block_out_channels": [32, 64, 128],
    "layers_per_block": 2, "attention_head_dim": [2, 4, 8], "num_attention_heads": None,
    "cross_attention_dim": 64, "addition_time_embed_dim": 8,
    "projection_class_embeddings_input_dim": 80, "norm_eps": 1e-5, "norm_num_groups": 32,
}
TINY_HF = {
    "unet": dict(
        _UNET_COMMON, down_block_types=["DownBlock2D", "CrossAttnDownBlock2D",
                                        "CrossAttnDownBlock2D"],
        up_block_types=["CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"],
        mid_block_type=None, transformer_layers_per_block=[[1, 1], [1, 1], [1, 2]],
        reverse_transformer_layers_per_block=[[1, 1, 2], [1, 0, 1], [1, 1, 1]]),
    "controlnet": dict(
        _UNET_COMMON, down_block_types=["DownBlock2D"] * 3, mid_block_type="UNetMidBlock2D",
        transformer_layers_per_block=[1, 1, 1], conditioning_channels=3,
        conditioning_embedding_out_channels=[8, 16]),
    "vae": {"in_channels": 3, "out_channels": 3, "latent_channels": 4,
            "block_out_channels": [16, 16, 32, 32], "layers_per_block": 1,
            "norm_num_groups": 8, "scaling_factor": 0.13025},
    "text_encoder": {"vocab_size": 1000, "hidden_size": 32, "intermediate_size": 64,
                     "num_hidden_layers": 2, "num_attention_heads": 2,
                     "max_position_embeddings": 77, "hidden_act": "quick_gelu",
                     "eos_token_id": 999},
    "text_encoder_2": {"vocab_size": 1000, "hidden_size": 32, "intermediate_size": 64,
                       "num_hidden_layers": 2, "num_attention_heads": 2,
                       "max_position_embeddings": 77, "hidden_act": "gelu",
                       "eos_token_id": 999, "projection_dim": 32},
}


def _port_configs():
    return {
        "unet": thf.unet_config_from_hf(TINY_HF["unet"]),
        "controlnet": thf.controlnet_config_from_hf(TINY_HF["controlnet"]),
        "vae": thf.vae_config_from_hf(TINY_HF["vae"]),
        "text_encoder": thf.clip_text_config_from_hf(TINY_HF["text_encoder"], False),
        "text_encoder_2": thf.clip_text_config_from_hf(TINY_HF["text_encoder_2"], True),
    }


def _seeded_models(seed=0):
    """The five tiny port models with seeded normals in every tensor (fan-in
    scaled, 0.2 for vectors), so biases and norms are exercised too."""
    classes = dict(unet=UNet2DConditionModel, controlnet=ControlNetModel, vae=AutoencoderKL,
                   text_encoder=CLIPTextModel, text_encoder_2=CLIPTextModel)
    rng = np.random.default_rng(seed)
    models = {}
    for name, cfg in _port_configs().items():
        model = classes[name](cfg)
        with torch.no_grad():
            for p in model.parameters():
                scale = 0.2 if p.dim() < 2 else 1.0 / math.sqrt(p[0].numel())
                p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape)) * scale))
        models[name] = model
    return types.SimpleNamespace(**models)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """The tiny snapshot and both converters' outputs: {(package, dtype): dir}."""
    root = tmp_path_factory.mktemp("ckpt")
    snap = root / "snapshot"
    written = chip_smoke.write_hf_snapshot(_seeded_models(), snap, TINY_HF, torch.float16)
    assert written > 0
    for tok in ("tokenizer", "tokenizer_2"):
        chip_smoke.write_tokenizer(snap / tok, vocab_size=1000)
    out = {}
    for package, module in (("port", tconvert), ("jax", jconvert)):
        for dtype in ("bf16", "fp32"):
            d = root / f"{package}_{dtype}"
            for kind in (*COMPONENTS, "tokenizer", "tokenizer_2"):
                module.convert_component("tokenizer" if kind.startswith("tokenizer") else kind,
                                         str(snap / kind), str(d / kind), dtype)
            out[package, dtype] = d
    out["snapshot"] = snap
    return out


def test_command_line_converts_as_the_function_does(converted, tmp_path):
    out = tmp_path / "unet"
    assert tconvert.main(["unet", "--src", str(converted["snapshot"] / "unet"), "--out",
                          str(out), "--dtype", "fp32"]) == 0
    assert (out / "config.json").read_text() == (
        converted["port", "fp32"] / "unet" / "config.json").read_text()
    _assert_same(tckpt.flatten(tckpt.load_params(str(out))),
                 tckpt.flatten(tckpt.load_params(str(converted["port", "fp32"] / "unet"))))
    with pytest.raises(SystemExit, match="DRIFTS"):
        tconvert.main(["unet", "--src", str(converted["snapshot"] / "unet"), "--out",
                       str(tmp_path / "x"), "--expect", "ssd-1b"])


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("component", COMPONENTS)
def test_converters_write_the_same_checkpoint(converted, component, dtype):
    port, ref = converted["port", dtype] / component, converted["jax", dtype] / component
    assert json.loads((port / "config.json").read_text()) == json.loads(
        (ref / "config.json").read_text())
    # the JAX loader reads the port's file as its own, tensor for tensor
    jport, jref = (jckpt.flatten(jckpt.load_params(str(d))) for d in (port, ref))
    assert sorted(jport) == sorted(jref)
    for k, v in jref.items():
        assert jport[k].dtype == v.dtype and jport[k].shape == v.shape, k
        np.testing.assert_array_equal(jport[k].astype(np.float32), v.astype(np.float32), k)
    # and the port's loader reads the JAX converter's file as its own
    _assert_same(tckpt.flatten(tckpt.load_params(str(ref))),
                 tckpt.flatten(tckpt.load_params(str(port))))


@pytest.fixture(scope="module")
def loaded(converted):
    d = converted["jax", "fp32"]
    return d, FastEditor("ssd-1b", checkpoint_dir=str(d), device="cpu", dtype=torch.float32)


STATE_DICTS = {
    "unet": (JC.UNetConfig, from_jax.unet_state_dict),
    "controlnet": (JC.ControlNetConfig, from_jax.controlnet_state_dict),
    "vae": (JC.VAEConfig, from_jax.vae_state_dict),
    "text_encoder": (JC.CLIPTextConfig, from_jax.clip_text_state_dict),
    "text_encoder_2": (JC.CLIPTextConfig, from_jax.clip_text_state_dict),
}


@pytest.mark.parametrize("component", COMPONENTS)
def test_editor_loads_every_parameter(loaded, component):
    d, editor = loaded
    cfg_cls, to_sd = STATE_DICTS[component]
    tcfg = _port_configs()[component]
    assert dataclasses.asdict(jckpt.load_config(str(d / component), cfg_cls)) == (
        dataclasses.asdict(tcfg))
    want = to_sd(jckpt.load_params(str(d / component)), tcfg)
    got = getattr(editor.modules, component).state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], v), k


def test_editor_loads_the_tokenizers(loaded):
    d, editor = loaded
    for name, pad in (("tokenizer", None), ("tokenizer_2", 0)):
        ref = JTokenizer.from_dir(str(d / name), pad_token_id=pad)
        port = getattr(editor, name)
        assert port.pad_token_id == ref.pad_token_id == (999 if pad is None else 0)
        for text in ("the cat and the hat", "in autumn, at night!"):
            np.testing.assert_array_equal(port.encode(text), ref.encode(text))


def _jparams(d, component):
    return jckpt.load_params(str(d / component), dtype=jnp.float32)


def test_loaded_unet_matches_jax(loaded):
    d, editor = loaded
    cfg = jckpt.load_config(str(d / "unet"), JC.UNetConfig)
    rng = np.random.default_rng(4)
    inputs = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32),
              np.asarray([759.0, 279.0], np.float32),
              rng.standard_normal((2, 77, 64)).astype(np.float32),
              rng.standard_normal((2, 32)).astype(np.float32),
              np.tile(np.asarray([[64, 64, 0, 0, 64, 64]], np.float32), (2, 1)))
    ref = JUNet(cfg).apply({"params": _jparams(d, "unet")}, *[jnp.asarray(a) for a in inputs])
    with torch.no_grad():
        out = editor.modules.unet(*[torch.from_numpy(a) for a in inputs])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_loaded_vae_matches_jax(loaded):
    d, editor = loaded
    cfg = jckpt.load_config(str(d / "vae"), JC.VAEConfig)
    img = np.random.default_rng(5).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    jvae, params = JVAE(cfg), _jparams(d, "vae")
    mean, logvar = jvae.apply({"params": params}, jnp.asarray(img), method=jvae.encode_moments)
    dec = jvae.apply({"params": params}, mean, method=jvae.decode)
    with torch.no_grad():
        tmean, tlogvar = editor.modules.vae.encode_moments(torch.from_numpy(img))
        tdec = editor.modules.vae.decode(torch.from_numpy(np.array(mean)))
    for got, want in ((tmean, mean), (tlogvar, logvar), (tdec, dec)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("component", ["text_encoder", "text_encoder_2"])
def test_loaded_clip_matches_jax(loaded, component):
    d, editor = loaded
    cfg = jckpt.load_config(str(d / component), JC.CLIPTextConfig)
    tok = editor.tokenizer if component == "text_encoder" else editor.tokenizer_2
    ids = np.stack([tok.encode("the cat and the hat"), tok.encode("an orchard at dusk")])
    ref = JCLIP(cfg).apply({"params": _jparams(d, component)}, jnp.asarray(ids))
    with torch.no_grad():
        out = getattr(editor.modules, component)(torch.from_numpy(ids).long())
    for field in ("last_hidden_state", "penultimate_hidden_state", "pooled_output"):
        np.testing.assert_allclose(getattr(out, field).numpy(),
                                   np.asarray(getattr(ref, field)), **TOL)


def test_missing_checkpoint_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="Checkpoint directory not found"):
        FastEditor("ssd-1b", checkpoint_dir=str(tmp_path / "absent"), device="cpu")


def test_full_controlnet_without_its_directory_raises(converted):
    """No silent downgrade to the small ControlNet."""
    with pytest.raises(FileNotFoundError, match="use_full_controlnet=True but"):
        FastEditor("ssd-1b", checkpoint_dir=str(converted["port", "bf16"]), device="cpu",
                   use_full_controlnet=True)


def test_cpu_offload_is_logged_as_not_needed(caplog):
    logger = logging.getLogger("fastedit_torch")
    logger.addHandler(caplog.handler)  # the port's logger does not propagate
    try:
        with caplog.at_level(logging.INFO, logger="fastedit_torch"):
            FastEditor("tiny", device="cpu", enable_cpu_offload=True)
    finally:
        logger.removeHandler(caplog.handler)
    notes = [r.getMessage() for r in caplog.records if "CPU offload" in r.getMessage()]
    assert len(notes) == 1 and "not needed" in notes[0]
    assert caplog.records[0].name == "fastedit_torch.FastEditor"
