"""The port's conformance tool (``fastedit_tpu_torch/tools/conformance.py``).

On the CPU it compares the CPU with itself (``--device cpu``): every check
holds and it exits 0.  A planted difference in one op, made on the device
side's call only, fails its check and exits 1.  With the default device and
no card it raises instead of reporting a conformance it did not check.  Its
Canny reference, the port's own copy of ``canny_np``, equals the JAX
package's bit for bit, and its stress masks are what they claim: the
serpentine and the zigzag one 8-connected chain each (every link of the
zigzag, and every turn of the serpentine, through a corner only).  On the
card it runs in ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from fastedit_tpu.ops.canny import canny_np as jax_canny_np
from fastedit_tpu_torch.metrics import functional
from fastedit_tpu_torch.ops.canny import canny_np
from fastedit_tpu_torch.tools import conformance


def test_cpu_against_itself_is_conformant(capsys):
    assert conformance.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[conformance] device=cpu host=cpu"
    assert out[-1] == "[conformance] all checks passed"
    checks = [line for line in out if " ok " in line]
    assert len(checks) == 13 and not [line for line in out if "FAIL" in line]


def _one_call_off(fn, by, call):
    """``fn`` with the output of its ``call``-th call moved by ``by``: a
    check runs the device side first, so only that side differs."""
    calls = []

    def planted(*args, **kw):
        out = fn(*args, **kw)
        calls.append(1)
        return out + by if len(calls) == call else out

    return planted


@pytest.mark.parametrize("module,name,by,call,check", [
    (functional, "psnr", 2e-3, 1, "psnr"),
    (functional, "mse", 1e-6, 3, "mse"),  # psnr's two calls come first
    (functional, "ssim", 2e-4, 1, "ssim (high-DC stress)"),
    (functional, "ssim", 2e-4, 3, "ssim (structured)"),
    (conformance, "canny_edges", 1, 1, "canny (device vs host)"),
    (conformance, "canny_edges", 1, 3, "canny thresholds (device vs numpy)"),
    (conformance, "hysteresis", 1, 1, "hysteresis chains (device vs fill)"),
    (conformance, "hysteresis", 1, 3, "hysteresis random (device vs fill)"),
    (conformance, "attention", 1e-2, 1, "attention (plain op, fp32 in)"),
    (conformance, "attention", 1e-2, 3, "flash attention (kernel vs plain)"),
    (conformance, "group_norm", 1e-2, 1, "group_norm+silu (kernel vs plain)"),
])
def test_a_planted_difference_fails_its_check(monkeypatch, capsys, module, name, by, call,
                                              check):
    monkeypatch.setattr(module, name, _one_call_off(getattr(module, name), by, call))
    assert conformance.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert f"[conformance] {check:38s} FAIL" in out
    assert "[conformance] FAILED:" in out.splitlines()[-1]


def test_the_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        conformance.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        conformance.main(["--device", "cpu", "--host", "cuda"])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["float", "uint8", "gray"])
@pytest.mark.parametrize("low,high", [(100, 200), (200, 100), (50.7, 120.2)])
def test_canny_np_equals_the_jax_packages(seed, kind, low, high):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (40, 52, 3))
    img[8:30, 10:25] = rng.integers(0, 256, 3)  # a block: long edges to grow along
    img = {"float": img.astype(np.float32) + 0.3, "uint8": img.astype(np.uint8),
           "gray": img[..., 0].astype(np.float64)}[kind]
    ours, theirs = canny_np(img, low, high), jax_canny_np(img, low, high)
    assert ours.dtype == theirs.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)
    assert ours.any()


@pytest.mark.parametrize("size", [64, 128])
def test_the_stress_masks_are_one_chain_through_corners(size):
    from scipy import ndimage

    eight = np.ones((3, 3), bool)
    for name, chain in (("serpentine", conformance.serpentine(size, size)),
                        ("zigzag", conformance.zigzag(size, size))):
        assert ndimage.label(chain, eight)[1] == 1, name
        four = ndimage.label(chain)[1]
        # without the diagonal links the chain falls apart: every row of the
        # serpentine, every pixel of the zigzag on its own
        assert four == (size - 1 if name == "serpentine" else chain.sum()), (name, four)
    serp = conformance.serpentine(64, 64)
    assert 2000 <= serp.sum() <= 2100
    classes = dict(conformance.stress_classes(size=size))
    assert (classes["serpentine"] == 2).sum() == 1
    assert 0.05 < (classes["random 0.1"] != 0).mean() < 0.15
