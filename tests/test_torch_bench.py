"""The analytic FLOPs, and the editor's graph keys and bounded caches, on the
CPU.

``fastedit_tpu_torch/utils/flops.py`` is the port's copy of the JAX
package's: its ``edit_flops`` must give the same number over the port's
configs (exact: the same float arithmetic in the same order).  The graph
key and the caches are pure Python: the key holds the shapes a capture
serves, and the graph and schedule caches keep at most 64 entries, evicting
the oldest, as the JAX package's caches do.  The kernel flags and the stage
are per thread: an override or a stage in one thread moves no other
thread's.
"""

import threading
import types

import pytest
import torch
import torch.nn as nn

from fastedit_tpu.models import configs as JC
from fastedit_tpu.utils import flops as jflops

from fastedit_tpu_torch import FastEditor
from fastedit_tpu_torch.models import configs as TC
from fastedit_tpu_torch.ops import flags
from fastedit_tpu_torch.pipeline import graphs
from fastedit_tpu_torch.utils import flops as tflops

MODELS = {  # (UNet, ControlNet, VAE, resolution) by model
    "ssd-1b": ("SSD1B_UNET", "SDXL_CONTROLNET_SMALL", "SDXL_VAE", 1024),
    "sdxl": ("SDXL_UNET", "SDXL_CONTROLNET_SMALL", "SDXL_VAE", 1024),
    "sdxl-full-controlnet": ("SDXL_UNET", "SDXL_CONTROLNET_FULL", "SDXL_VAE", 1024),
    "tiny": ("TINY_UNET", "TINY_CONTROLNET", "TINY_VAE", 64),
}


@pytest.mark.parametrize("steps", [1, 2, 3, 4])
@pytest.mark.parametrize("do_cfg", [True, False], ids=["cfg", "nocfg"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_edit_flops_equal_jax(model, do_cfg, steps):
    *names, res = MODELS[model]
    port = tflops.edit_flops(*(getattr(TC, n) for n in names), resolution=res,
                             num_steps_run=steps, do_cfg=do_cfg)
    ref = jflops.edit_flops(*(getattr(JC, n) for n in names), resolution=res,
                            num_steps_run=steps, do_cfg=do_cfg)
    assert port == ref and port > 0


@pytest.mark.parametrize("batch", [2, 4])
def test_edit_flops_of_a_batch_equal_jax(batch):
    *names, res = MODELS["ssd-1b"]
    kw = dict(resolution=res, num_steps_run=3, do_cfg=True, batch=batch)
    port = tflops.edit_flops(*(getattr(TC, n) for n in names), **kw)
    assert port == jflops.edit_flops(*(getattr(JC, n) for n in names), **kw)
    one = tflops.edit_flops(*(getattr(TC, n) for n in names), **{**kw, "batch": 1})
    assert port == pytest.approx(batch * one, rel=1e-12)


def test_flag_overrides_are_per_thread():
    """A worker's override (``plain_versions``, as a comparison thread would
    set it) and its stage are not seen by the main thread; a thread started
    inside the main thread's override and stage sees the defaults, outside
    any stage."""
    x, w = (1, 8, 8, 64), (64, 64, 3, 3)
    entered, release, seen = threading.Event(), threading.Event(), {}

    def worker():
        with flags.override(plain_versions=True, cuda_graphs=False), flags.stage("decode"):
            seen["inside"] = flags.current()
            seen["conv"] = flags.takes("conv3x3", x, w)
            entered.set()
            release.wait(30)
        seen["after"] = (flags.current(), flags.current_stage())

    t = threading.Thread(target=worker)
    t.start()
    try:
        assert entered.wait(30)
        assert flags.current() == flags.KernelFlags() and flags.use_cuda_graphs()
        assert flags.current_stage() is None and not flags.takes("conv3x3", x, w)
    finally:
        release.set()
        t.join(30)
    assert not t.is_alive()
    assert seen["inside"] == flags.KernelFlags(plain_versions=True, cuda_graphs=False)
    assert seen["conv"] and seen["after"] == (flags.KernelFlags(), None)

    with flags.override(cuda_graphs=False), flags.stage("denoise"):
        t = threading.Thread(target=lambda: seen.update(
            fresh=(flags.current(), flags.current_stage())))
        t.start()
        t.join(30)
        assert not flags.use_cuda_graphs()
    assert not t.is_alive() and seen["fresh"] == (flags.KernelFlags(), None)
    assert flags.FLAGS == flags.KernelFlags()


def test_override_rejects_an_unknown_flag():
    with pytest.raises(AttributeError):
        with flags.override(current=False):
            pass
    assert flags.FLAGS == flags.KernelFlags()


def test_graph_key_holds_the_shapes():
    keys = {graphs.graph_key(*k) for k in [
        (1, True, 3, False, 1024), (2, True, 3, False, 1024), (1, False, 3, False, 1024),
        (1, True, 2, False, 1024), (2, True, 3, True, 1024), (1, True, 3, False, 64)]}
    assert len(keys) == 6


class _Inputs:
    def copy_(self, other):
        pass


def test_graph_cache_stops_at_64_and_drops_all_on_new_weights(monkeypatch):
    """``EditGraphs.run`` with the capture replaced by a stub: at most
    MAX_KEYS captures, the oldest evicted first, and none kept once a weight
    changes."""
    layer = nn.Linear(2, 2)
    mod = types.SimpleNamespace(unet=layer, controlnet=nn.Module(), vae=nn.Module())
    eg = graphs.EditGraphs(mod)
    captures = []

    def capture(inp):
        captures.append(inp)
        return graphs.Captured(_Inputs(), {}, latents=None, out=len(captures), pool_bytes=0)

    monkeypatch.setattr(eg, "_capture", capture)
    for i in range(70):
        assert eg.run(("key", i), None)[1] == i + 1
    assert len(eg.captured) == graphs.MAX_KEYS == 64
    assert list(eg.captured) == [("key", i) for i in range(6, 70)]
    assert eg.run(("key", 69), None)[1] == 70 and len(captures) == 70  # a replay
    with torch.no_grad():
        layer.weight.add_(1.0)  # written in place
    assert eg.run(("key", 69), None)[1] == 71 and list(eg.captured) == [("key", 69)]


def test_schedule_cache_stops_at_64():
    ed = FastEditor("tiny", device="cpu", dtype=torch.float32)
    keys = [(steps, strength) for steps in range(2, 37) for strength in (1.0, 0.75)]
    for steps, strength in keys:
        sched = ed._schedule(steps, strength)
        assert sched.table.shape == (7, sched.num_steps) and sched.table.device == ed.device
    assert list(ed._schedule_cache) == [(s, float(g)) for s, g in keys[-64:]]
    ed.clear_memory()
    assert not ed._schedule_cache and ed._graphs is None


def test_launch_counts_name_every_kernel_and_reset():
    from fastedit_tpu_torch.ops import conv_fused
    from fastedit_tpu_torch.tools import inventory

    conv_fused.launches["conv3x3_up2"] += 3
    assert inventory.launch_counts()["conv3x3_up2"] >= 3
    inventory.reset_launch_counts()
    counts = inventory.launch_counts()
    assert tuple(counts) == inventory.KERNELS and not any(counts.values())
