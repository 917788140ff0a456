"""The benchmark's frozen copies against the program they were copied from:
the FLOP count, the kernel families, the work counts, the seeded weights'
parameter list, the configurations' sizes and the scenes."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from benchmark import device_trace, scenes, weights, work
from benchmark.reference import canny as ref_canny
from fastedit_tpu_torch.models import configs as C
from fastedit_tpu_torch.models.clip import CLIPTextModel
from fastedit_tpu_torch.models.controlnet import ControlNetModel
from fastedit_tpu_torch.models.unet import UNet2DConditionModel
from fastedit_tpu_torch.models.vae import AutoencoderKL
from fastedit_tpu_torch.ops import canny as port_canny
from fastedit_tpu_torch.tools.profile_edit import CATEGORIES
from fastedit_tpu_torch.utils import flops

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("ssd1b-bf16", "ssd1b-fp32")


def config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def asdict(x):
    return json.loads(json.dumps(dataclasses.asdict(x)))


@pytest.mark.parametrize("name", CONFIGS)
def test_configuration_is_the_programs(name):
    cfg = config(name)
    assert cfg["unet"] == asdict(C.SSD1B_UNET)
    assert cfg["controlnet"] == asdict(C.SDXL_CONTROLNET_SMALL)
    assert cfg["vae"] == asdict(C.SDXL_VAE)
    assert cfg["text_encoder"] == asdict(C.SDXL_TEXT_ENCODER)
    assert cfg["text_encoder_2"] == asdict(C.SDXL_TEXT_ENCODER_2)
    assert cfg["resolution"] == cfg["control_resolution"] == 1024


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("do_cfg", [True, False])
@pytest.mark.parametrize("batch", [1, 4])
def test_edit_flops_equal_the_programs(name, do_cfg, batch):
    cfg = config(name)
    port = flops.edit_flops(C.SSD1B_UNET, C.SDXL_CONTROLNET_SMALL, C.SDXL_VAE, 1024, 3,
                            do_cfg, batch)
    assert work.edit_flops(cfg, do_cfg, batch) == port


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("do_cfg", [True, False])
def test_conv_linear_attention_sum_to_edit_flops(name, do_cfg):
    cfg = config(name)
    fam = work.family_flops(work.edit_ops(cfg, do_cfg, 4))
    assert set(fam) == {"conv", "linear", "attention"}
    assert sum(fam.values()) == pytest.approx(work.edit_flops(cfg, do_cfg, 4), rel=1e-12)


def test_work_counts_bytes_and_needed():
    cfg = config("ssd1b-bf16")
    ops = work.edit_ops(cfg, True, 1)
    assert all(op.bytes > 0 and 0 < op.needed <= op.flops for op in ops)
    up = [op for op in ops if op.needed < op.flops]
    # two upsample convs per UNet call (3 steps) and three in the VAE decoder
    assert len(up) == 3 * 2 + 3
    assert all(op.needed == pytest.approx(op.flops * 4 / 9) for op in up)
    f32 = work.edit_ops(config("ssd1b-fp32"), True, 1)
    assert [2 * a.bytes for a in ops] == [b.bytes for b in f32]


KNOWN_FAMILY = {  # profile_edit's categories, grouped as the benchmark groups them
    "cuDNN conv": "conv", "GEMM (cuBLAS)": "linear", "softmax": "softmax",
    "reduction": "reduction", "copy / layout": "copy", "elementwise": "elementwise",
}


def _expected(category):
    if category in KNOWN_FAMILY:
        return KNOWN_FAMILY[category]
    low = category.lower()
    for part, fam in (("groupnorm", "groupnorm"), ("attention", "attention"), ("conv", "conv")):
        if part in low:
            return fam
    raise KeyError(category)


@pytest.mark.parametrize("category,name", [(c, n) for c, names in CATEGORIES for n in names])
def test_every_known_kernel_name_in_one_family(category, name):
    table = device_trace.families()
    hits = [fam for fam, parts in table if any(p in name.lower() for p in parts)]
    assert hits, name
    assert device_trace.family_of(name, table) == _expected(category)
    # where several rows match, they name one family: first match is no tie-break
    assert len(set(hits)) == 1 or hits[0] == _expected(category)


def _port_models():
    with torch.device("meta"):
        return {"unet": UNet2DConditionModel(C.SSD1B_UNET),
                "controlnet": ControlNetModel(C.SDXL_CONTROLNET_SMALL),
                "vae": AutoencoderKL(C.SDXL_VAE),
                "text_encoder": CLIPTextModel(C.SDXL_TEXT_ENCODER),
                "text_encoder_2": CLIPTextModel(C.SDXL_TEXT_ENCODER_2)}


@pytest.mark.parametrize("name", CONFIGS)
def test_seeded_weights_cover_the_programs_parameters(name):
    port = {f"{k}.{n}": tuple(p.shape) for k, m in _port_models().items()
            for n, p in m.named_parameters()}
    assert {n: s for n, s, _ in weights.spec(config(name))} == port


def test_seeded_weights_repeat_and_scale():
    with open(os.path.join(BENCH, "tests", "fixtures", "tiny-fp32.json")) as f:
        cfg = json.load(f)
    a = dict(weights.draw(cfg, 2 ** 40 + 7, "cpu"))
    b = dict(weights.draw(cfg, 2 ** 40 + 7, "cpu"))
    c = dict(weights.draw(cfg, 2 ** 40 + 8, "cpu"))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    w = "unet.down_blocks.1.attentions.0.transformer_blocks.0.ff.net.0.proj.weight"
    assert not torch.equal(a[w], c[w])
    assert a[w].std().item() == pytest.approx(a[w].shape[1] ** -0.5, rel=0.05)
    assert torch.all(a["vae.encoder.conv_norm_out.weight"] == 1)
    assert torch.all(a["unet.conv_in.bias"] == 0)
    emb = a["text_encoder.text_model.embeddings.token_embedding.weight"]
    assert emb.std().item() == pytest.approx(0.02, rel=0.05)


def test_scenes_repeat_and_give_edges():
    s, t = scenes.Scenes(2 ** 33 + 1, 256), scenes.Scenes(2 ** 33 + 1, 256)
    assert np.array_equal(s.images(3, 2), t.images(3, 2))
    assert not np.array_equal(s.image(3), s.image(4))
    prompts = s.prompts(0, 500)
    assert len(set(prompts)) == 500 and prompts == t.prompts(0, 500)
    share = ref_canny.edges(torch.from_numpy(s.images(0, 2)), 100, 200).float().mean().item()
    assert 0.01 < share < 0.3


def test_reference_canny_equals_the_programs():
    imgs = scenes.Scenes(9, 128).images(0, 3)
    want = np.stack([port_canny.canny_np(im, 100, 200) > 0 for im in imgs])
    got = ref_canny.edges(torch.from_numpy(imgs), 100, 200).numpy()
    assert np.array_equal(got, want)
