"""SDXL-base-1.0 in the port against the benchmark's plain reference
(``benchmark/reference/``, read only) on the CPU in fp32.

SDXL's block pattern (no attention in the first down block, 10-deep stacks
below, a mid block with a cross-attention transformer, a symmetric up path)
is cut here to depth 2 at the tiny widths: down ((0, 0), (1, 1), (2, 2)), mid
2, up ((2, 2, 2), (1, 1, 1), (0, 0, 0)), with the small ControlNet's pattern
(conv-only down blocks, an attention-free mid block).  The port's UNet, fed
the ControlNet's residuals, and a whole edit through ``FastEditor`` with
those modules are held against the reference on the benchmark's seeded
weights (``benchmark/weights.py``), and planted faults (the mid block
skipped, a transformer block's residual dropped) must fail the same
comparison.  Besides: the configuration file of the cell is
``models/configs.SDXL_UNET``, the benchmark's FLOP count is the program's
for SDXL, the seeded weights cover ``FastEditor("sdxl")``'s parameters name
for name, and an eager edit off the card leaves no denoise split record.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from benchmark import scenes, weights, work
from benchmark.reference import models as ref_models
from benchmark.reference.pipeline import Reference, to_uint8
from fastedit_tpu_torch.models import configs as C
from fastedit_tpu_torch.models.controlnet import ControlNetModel
from fastedit_tpu_torch.models.layers import BasicTransformerBlock
from fastedit_tpu_torch.models.unet import MidBlock, UNet2DConditionModel
from fastedit_tpu_torch.pipeline import editor as editor_mod
from fastedit_tpu_torch.pipeline.editor import FastEditor
from fastedit_tpu_torch.utils import flops, profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
SEED = 2 ** 31 + 23  # more than 32 signed bits hold, as a run's seed may

# Both sides compute in fp32 on the CPU and differ only in the order of their
# sums (NHWC against NCHW, the port's attention and norms against SDPA and
# written-out norms): the UNet's output and the ControlNet's residuals agree to
# 0.8-1.9e-6 of their largest value.  The limit leaves 50x room above that; the
# planted faults read 0.24 (mid block skipped) and 0.80 (residual dropped).
EPS_REL = 1e-4
# The edit's images: the tiny editor's own limit against the reference
# (benchmark/tests/test_benchmark_reference.py): the rounding to uint8 turns
# the fp32 differences into at most one LSB on a few pixels (8e-5 LSB mean);
# a skipped mid block reads 58 LSB at most, 6.3 on average.
LSB_MAX, LSB_MEAN = 1, 1e-3


def _sdxl_small() -> dict:
    """The tiny configuration with SDXL's block pattern at depth 2."""
    with open(os.path.join(BENCH, "tests", "fixtures", "tiny-fp32.json")) as f:
        cfg = json.load(f)
    unet = dict(cfg["unet"], layers_per_block=2,
                down_transformer_layers=[[0, 0], [1, 1], [2, 2]], mid_transformer_layers=2,
                up_transformer_layers=[[2, 2, 2], [1, 1, 1], [0, 0, 0]])
    cn = dict(unet, down_transformer_layers=[[0, 0]] * 3, mid_transformer_layers=0,
              up_transformer_layers=[[0, 0, 0]] * 3)
    cfg["unet"], cfg["controlnet"] = unet, dict(cfg["controlnet"], unet=cn)
    return cfg


def _tuples(x):
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else x


def _unet_config(u: dict) -> C.UNetConfig:
    return C.UNetConfig(**{k: _tuples(v) for k, v in u.items()})


def _asdict(x):
    return json.loads(json.dumps(dataclasses.asdict(x)))


@pytest.fixture(scope="module")
def small():
    """(cfg, the port's UNet and ControlNet, the reference's five models),
    on one seed's weights."""
    cfg = _sdxl_small()
    c = cfg["controlnet"]
    unet = UNet2DConditionModel(_unet_config(cfg["unet"])).eval()
    cn = ControlNetModel(C.ControlNetConfig(
        unet=_unet_config(c["unet"]), conditioning_channels=c["conditioning_channels"],
        conditioning_embedding_channels=tuple(c["conditioning_embedding_channels"]))).eval()
    ref = Reference(cfg, weights.draw(cfg, SEED, "cpu"), "cpu")
    params = {f"{prefix}.{n}": p for prefix, m in (("unet", unet), ("controlnet", cn))
              for n, p in m.named_parameters()}
    with torch.no_grad():
        for name, value in weights.draw(cfg, SEED, "cpu"):
            if name.split(".")[0] in ("unet", "controlnet"):
                params.pop(name).copy_(value)
    assert not params
    return cfg, unet, cn, ref


def _inputs(cfg, batch=2):
    g = torch.Generator().manual_seed(7)
    u = cfg["unet"]
    lat = torch.randn(batch, 8, 8, u["in_channels"], generator=g)
    t = torch.tensor([759.0, 499.0][:batch])
    ctx = torch.randn(batch, 77, u["cross_attention_dim"], generator=g)
    pooled_dim = u["projection_class_embeddings_input_dim"] - 6 * u["addition_time_embed_dim"]
    pooled = torch.randn(batch, pooled_dim, generator=g)
    ids = torch.tensor([[64.0, 64.0, 0.0, 0.0, 64.0, 64.0]]).repeat(batch, 1)
    control = (torch.rand(batch, cfg["control_resolution"], cfg["control_resolution"], 3,
                          generator=g) > 0.7).float()
    return lat, t, ctx, pooled, ids, control


def _unet_pair(small):
    """The port's eps and the reference's (NHWC) on the same inputs, each
    UNet fed its own ControlNet's residuals at scale 0.5."""
    cfg, unet, cn, ref = small
    lat, t, ctx, pooled, ids, control = _inputs(cfg)
    with torch.no_grad():
        down, mid = cn(lat, t, ctx, pooled, ids, control, 0.5)
        got = unet(lat, t, ctx, pooled, ids, down_block_additional_residuals=down,
                   mid_block_additional_residual=mid)
        m = ref.models
        x = lat.permute(0, 3, 1, 2)
        cond = m["controlnet"].controlnet_cond_embedding(control.permute(0, 3, 1, 2))
        rdown, rmid = m["controlnet"](x, t, ctx, pooled, ids, cond, 0.5)
        want = m["unet"](x, t, ctx, pooled, ids, rdown, rmid).permute(0, 2, 3, 1)
    return got, want, (down, mid), (rdown, rmid)


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def test_the_unet_fed_the_controlnets_residuals_matches_the_reference(small):
    got, want, (down, mid), (rdown, rmid) = _unet_pair(small)
    assert len(down) == len(rdown) == 9  # conv_in, 2 x (2 resnets + down), 2 resnets
    for a, b in zip(down, rdown):
        assert _rel(a, b.permute(0, 2, 3, 1)) < EPS_REL
    assert _rel(mid, rmid.permute(0, 2, 3, 1)) < EPS_REL
    assert float(rmid.abs().max()) > 0.1  # the mid residual is not zero
    assert got.shape == want.shape and _rel(got, want) < EPS_REL


def _mid_skipped(monkeypatch):
    monkeypatch.setattr(MidBlock, "forward", lambda self, x, temb, context: x)


def _residual_dropped(monkeypatch):
    """The cross-attention's residual dropped in every transformer block."""
    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))

    monkeypatch.setattr(BasicTransformerBlock, "forward", forward)


@pytest.mark.parametrize("fault", [_mid_skipped, _residual_dropped])
def test_a_planted_fault_fails_the_unet_comparison(small, monkeypatch, fault):
    fault(monkeypatch)
    got, want, _, _ = _unet_pair(small)
    assert _rel(got, want) > 100 * EPS_REL


@pytest.fixture(scope="module")
def editor(small):
    """The tiny CPU editor with the SDXL-pattern UNet and ControlNet in
    place of its own, every weight the seed's."""
    cfg, unet, cn, _ = small
    ed = FastEditor("tiny", device="cpu", use_full_precision=True)
    ed.modules = dataclasses.replace(ed.modules, unet=unet, controlnet=cn)
    weights.fill_program(ed, cfg, SEED)
    return ed


def _worst(got, want) -> tuple:
    d = np.abs(got.astype(int) - to_uint8(want).numpy().astype(int))
    return d.max(), d.mean()


def _edit(editor, small, guidance):
    cfg, _, _, ref = small
    s = scenes.Scenes(SEED, cfg["resolution"])
    imgs, prompts = s.images(0, 2), s.prompts(0, 2)
    got = np.stack([np.asarray(im) for im in editor.edit_batch(
        imgs, prompts, guidance_scale=guidance, seed=321)])
    want = ref.edit(torch.from_numpy(imgs), prompts, guidance, 321, tile_noise=True)
    return got, want


@pytest.mark.parametrize("guidance", [1.5, 1.0])
def test_the_denoise_loop_matches_the_reference_pipeline(editor, small, guidance):
    """A whole edit of two scenes: the denoise loop's three steps under the
    LCM sampler, the ControlNet's residuals into an attention mid block, CFG
    (or none), decoded: within the tiny editor's own limit of the reference."""
    got, want = _edit(editor, small, guidance)
    dmax, dmean = _worst(got, want)
    assert dmax <= LSB_MAX and dmean < LSB_MEAN
    assert 0.05 < (got > 0).mean() and (got < 255).mean() > 0.05  # not saturated


def test_a_skipped_mid_block_fails_the_edit_comparison(editor, small, monkeypatch):
    _mid_skipped(monkeypatch)
    got, want = _edit(editor, small, 1.5)
    dmax, dmean = _worst(got, want)
    assert dmax > LSB_MAX and dmean > LSB_MEAN


def test_the_cells_configuration_is_sdxls():
    with open(os.path.join(BENCH, "configs", "sdxl-bf16.json")) as f:
        cfg = json.load(f)
    assert cfg["unet"] == _asdict(C.SDXL_UNET)
    assert cfg["unet"]["mid_transformer_layers"] == 10
    assert cfg["controlnet"] == _asdict(C.SDXL_CONTROLNET_SMALL)
    assert cfg["vae"] == _asdict(C.SDXL_VAE)
    assert cfg["text_encoder"] == _asdict(C.SDXL_TEXT_ENCODER)
    assert cfg["text_encoder_2"] == _asdict(C.SDXL_TEXT_ENCODER_2)
    assert cfg["program"] == {"model_name": "sdxl", "random_weights": True,
                              "use_full_precision": False}
    unet = ref_models.build(cfg)["unet"]
    assert sum(p.numel() for p in unet.parameters()) == 2_567_463_684  # published 2.57 B


@pytest.mark.parametrize("do_cfg", [True, False])
@pytest.mark.parametrize("batch", [1, 4])
def test_the_benchmarks_flops_are_the_programs_for_sdxl(do_cfg, batch):
    with open(os.path.join(BENCH, "configs", "sdxl-bf16.json")) as f:
        cfg = json.load(f)
    port = flops.edit_flops(C.SDXL_UNET, C.SDXL_CONTROLNET_SMALL, C.SDXL_VAE, 1024, 3, do_cfg,
                            batch)
    assert work.edit_flops(cfg, do_cfg, batch) == port


def test_the_seeded_weights_cover_fastedit_sdxls_parameters(monkeypatch):
    """``FastEditor("sdxl", random_weights=True)`` built on the meta device
    (its own choice of models, no memory): every parameter is the
    configuration's, name for name and shape for shape."""
    monkeypatch.setattr(editor_mod, "_resolve_device", lambda device: torch.device("meta"))
    ed = FastEditor("sdxl", random_weights=True)
    with open(os.path.join(BENCH, "configs", "sdxl-bf16.json")) as f:
        cfg = json.load(f)
    have = {n: tuple(p.shape) for n, p in weights.program_parameters(ed).items()}
    assert have == {n: s for n, s, _ in weights.spec(cfg)}


def test_an_eager_edit_off_the_card_leaves_no_denoise_split(editor, small):
    """Off the card there is no stamp buffer: the edit's ``stage.*`` records
    are absent (the CPU has no CUDA events), and so are the split's, rather
    than zero."""
    t = time.perf_counter_ns()
    cfg = small[0]
    s = scenes.Scenes(SEED + 1, cfg["resolution"])
    pending = editor.edit_batch_async(s.images(0, 1), s.prompts(0, 1), seed=4)
    assert len(pending.result()) == 1
    assert pending._parts[0].times.marks is None
    assert profiling.records(("stage.denoise", "stage.denoise.controlnet",
                              "stage.denoise.unet"), t) == []
