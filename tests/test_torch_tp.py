"""Tensor parallelism (``parallel/tp.py``, ``FastEditor.enable_data_parallel(...,
model_parallel=k)``, ``run_batch --model_parallel``) on the CPU.

The rules, as the JAX package's ``tests/test_tp.py`` holds its specs: which
state-dict entries split and on which dim, the row-parallel biases
replicated, a layer that ``tp`` does not divide replicated.  The tiny fp32
editor split over ``["cpu", "cpu"]`` against the same editor without TP:
final latents within rel L2 1e-5 (the partial products summed in another
order than one product's) and images within 1 LSB.  The port's TP edit
against the JAX package's TP edit on a (data=1, model=2) mesh of its virtual
CPU devices, with the same weights (``tools/from_jax``) and the JAX editor's
own noise: within 1 LSB, the tolerance ``tests/test_torch_pipeline.py``
holds the tiny editors to (fp32 op order can move a value across a rounding
boundary).  The group's shape, the error for an indivisible list, and
``run_batch --model_parallel 2`` on the CPU.
"""

import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from fastedit_tpu.ops import flags as jflags
from fastedit_tpu.parallel.mesh import make_mesh
from test_torch_pipeline import carried_editors

from fastedit_tpu_torch import FastEditor
from fastedit_tpu_torch import run_batch as trun_batch
from fastedit_tpu_torch.ops import flags
from fastedit_tpu_torch.parallel import tp
from fastedit_tpu_torch.pipeline import editor as teditor
from fastedit_tpu_torch.tools import make_demo_data

BLOCK = "down_blocks.1.attentions.0.transformer_blocks.0"


def _img(seed, n=64):
    rng = np.random.default_rng(seed)
    img = rng.integers(60, 200, (n, n, 3)).astype(np.int32)
    img[10:40, 12:30] += 50
    return Image.fromarray(np.clip(img, 0, 255).astype(np.uint8), "RGB")


@pytest.mark.parametrize("name,shape,heads,want", [
    (f"{BLOCK}.attn1.to_q.weight", (640, 640), 10, ("column", 0)),
    (f"{BLOCK}.attn2.to_k.weight", (640, 2048), 10, ("column", 0)),
    (f"{BLOCK}.attn2.to_v.bias", (640,), 10, ("column", 0)),
    (f"{BLOCK}.ff.net.0.proj.weight", (5120, 640), None, ("column", 0)),
    (f"{BLOCK}.ff.net.0.proj.bias", (5120,), None, ("column", 0)),
    (f"{BLOCK}.attn1.to_out.0.weight", (640, 640), 10, ("row", 1)),
    (f"{BLOCK}.ff.net.2.weight", (640, 2560), None, ("row", 1)),
    # the row-parallel biases stay whole: added once, after the sum
    (f"{BLOCK}.attn1.to_out.0.bias", (640,), 10, None),
    (f"{BLOCK}.ff.net.2.bias", (640,), None, None),
    # a layer that does not divide stays replicated: 5 heads, a hidden width of 2 x 641
    (f"{BLOCK}.attn1.to_q.weight", (320, 320), 5, None),
    (f"{BLOCK}.attn1.to_out.0.weight", (320, 320), 5, None),
    (f"{BLOCK}.ff.net.0.proj.weight", (1282, 640), None, None),
    (f"{BLOCK}.ff.net.2.weight", (640, 641), None, None),
    # everything else replicated
    (f"{BLOCK}.norm1.weight", (640,), None, None),
    ("down_blocks.1.attentions.0.proj_in.weight", (640, 640), None, None),
    ("down_blocks.1.resnets.0.conv1.weight", (640, 320, 3, 3), None, None),
    ("mid_block.attentions.0.to_q.weight", (512, 512), 1, None),  # not in a transformer block
])
def test_tp_rules(name, shape, heads, want):
    assert tp.tp_rule(name, shape, 2, heads) == want
    assert tp.tp_rule(name, shape, 1, heads) is None


def test_split_follows_the_rules_and_keeps_the_products():
    """Each split module gives its whole module's output (fp32 sums in
    another order), and an indivisible group keeps the modules whole."""
    ed = FastEditor("tiny", device="cpu", dtype=torch.float32, init_seed=2)
    unet = ed.modules.unet
    blocks = [m for m in unet.modules() if isinstance(m, tp.BasicTransformerBlock)]
    block = blocks[0]
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, block.attn1.to_q.in_features, generator=gen)
    ctx = torch.randn(2, 77, block.attn2.to_k.in_features, generator=gen)
    want = [block.attn1(x), block.attn2(x, ctx), block.ff(x)]
    counts = tp.split_transformers(unet, [torch.device("cpu")] * 2)
    assert counts == {"attention_split": 2 * len(blocks), "attention_replicated": 0,
                      "ff_split": len(blocks), "ff_replicated": 0}
    assert isinstance(block.attn1, tp.TPAttention) and isinstance(block.ff, tp.TPFeedForward)
    got = [block.attn1(x), block.attn2(x, ctx), block.ff(x)]
    for g, w in zip(got, want):
        assert float((g - w).norm() / w.norm()) < 1e-6
    # three devices divide neither 2, 4 nor 8 heads: every attention stays whole
    cn = ed.modules.controlnet
    n_blocks = sum(isinstance(m, tp.BasicTransformerBlock) for m in cn.modules())
    counts = tp.split_transformers(cn, [torch.device("cpu")] * 3)
    assert counts["attention_split"] == 0 and counts["attention_replicated"] == 2 * n_blocks


@pytest.fixture(scope="module")
def tiny():
    return FastEditor("tiny", device="cpu", dtype=torch.float32, init_seed=4)


def test_group_shape_and_the_indivisible_list():
    ed = FastEditor("tiny", device="cpu", dtype=torch.float32, init_seed=4)
    with pytest.raises(ValueError, match="does not divide"):
        ed.enable_data_parallel(["cpu"] * 3, model_parallel=2)
    group = ed.enable_data_parallel(["cpu"] * 4, model_parallel=2)
    assert group.shape == {"data": 2, "model": 2}
    assert all(r is not ed and r._graphs is None for r in group.replicas)
    for r in group.replicas:
        split = [m for m in r.modules.unet.modules() if isinstance(m, tp.TPAttention)]
        assert split and all(m.devices == [torch.device("cpu")] * 2 for m in split)
    # this editor's own modules stay whole
    assert not any(isinstance(m, (tp.TPAttention, tp.TPFeedForward))
                   for name in ("unet", "controlnet")
                   for m in getattr(ed.modules, name).modules())
    assert ed.enable_data_parallel(model_parallel=2).shape == {"data": 1, "model": 2}
    assert ed.enable_data_parallel(["cpu"] * 2).shape == {"data": 2, "model": 1}


def test_a_group_across_processes_is_not_ported(monkeypatch):
    """One device in each of two processes: a group of two would take a
    device of each, which is not ported."""
    from fastedit_tpu_torch.parallel import multihost

    ed = FastEditor("tiny", device="cpu", dtype=torch.float32, init_seed=4)
    monkeypatch.setattr(multihost, "rank_and_world", lambda: (0, 2))
    with pytest.raises(NotImplementedError, match="several processes"):
        ed.enable_data_parallel(["cpu"], model_parallel=2)
    with pytest.raises(ValueError, match="does not divide"):
        ed.enable_data_parallel(["cpu"], model_parallel=3)


def test_tp_edit_matches_the_editor_without_tp(tiny, monkeypatch):
    images, prompts = [_img(0), _img(1)], ["a red bicycle", "a small boat"]
    ref = tiny.edit_batch(images, prompts, seed=11)
    ref_latents = tiny.last_latents.clone()
    seen = []
    real = teditor.FastEditor._dispatch

    def spy(self, *args, **kw):
        seen.append(flags.current())
        return real(self, *args, **kw)

    monkeypatch.setattr(teditor.FastEditor, "_dispatch", spy)
    group = tiny.enable_data_parallel(["cpu", "cpu"], model_parallel=2)
    try:
        assert group.shape == {"data": 1, "model": 2}
        out = tiny.edit_batch(images, prompts, seed=11)
        latents = group.replicas[0].last_latents
    finally:
        tiny._group = None
    # the replica runs the caller's kernel flags: a TP replica pins none
    assert seen == [flags.current()]
    rel = float((latents - ref_latents).norm() / ref_latents.norm())
    assert rel <= 1e-5, rel
    for a, b in zip(out, ref):
        d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
        assert d.max() <= 1, d.max()


def test_tp_edit_matches_the_jax_packages_tp_edit(tiny_editor_f32):
    """Both editors split over two devices: the JAX package's on a (data=1,
    model=2) mesh, the port's over ["cpu", "cpu"]."""
    jed, ted = carried_editors(tiny_editor_f32)
    m = jed.modules
    attrs = ("unet_params", "controlnet_params", "vae_params", "text_encoder_params",
             "text_encoder_2_params")
    saved = {a: getattr(m, a) for a in attrs}
    kw = dict(seed=13, guidance_scale=1.5, strength=0.8, num_inference_steps=4)
    try:
        with jflags.override():  # restores the flags JAX's TP pins
            mesh = jed.enable_data_parallel(make_mesh(devices=jax.devices()[:2],
                                                      model_parallel=2), model_parallel=2)
            assert dict(mesh.shape) == {"data": 1, "model": 2}
            ref = jed.edit_batch([_img(3)], ["a watercolor harbor"], **kw)
    finally:
        jed.mesh = None
        dev0 = jax.devices()[0]
        for a, v in saved.items():
            setattr(m, a, jax.device_put(v, dev0) if v is not None else None)
        jed._rebuild_stages()
        jed._prompt_cache = {}
    ted.enable_data_parallel(["cpu", "cpu"], model_parallel=2)
    out = ted.edit_batch([_img(3)], ["a watercolor harbor"], **kw)
    d = np.abs(np.asarray(out[0], np.int32) - np.asarray(ref[0], np.int32))
    assert d.max() <= 1, f"max diff {d.max()} LSB"


def test_run_batch_model_parallel_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("FASTEDIT_PLATFORM", "cpu")
    root = tmp_path / "demo"
    make_demo_data.main(["--out", str(root), "--n", "2", "--size", "64"])
    groups = []
    enable = teditor.FastEditor.enable_data_parallel

    def spy(self, devices=None, model_parallel=1):
        groups.append(enable(self, devices, model_parallel))
        return groups[-1]

    monkeypatch.setattr(teditor.FastEditor, "enable_data_parallel", spy)
    out = tmp_path / "out"
    assert trun_batch.main(["--mapping_file", str(root / "mapping_file.json"),
                            "--source_dir", str(root / "annotation_images"), "--model", "tiny",
                            "--model_parallel", "2", "--seed", "1",
                            "--output_dir", str(out)]) == 0
    assert [g.shape for g in groups] == [{"data": 1, "model": 2}]
    saved = sorted(out.rglob("*.jpg"))
    assert len(saved) == 2
    cfg = json.loads(next(out.rglob("run_config.json")).read_text())
    assert cfg["model_parallel"] == 2 and cfg["data_parallel"]
