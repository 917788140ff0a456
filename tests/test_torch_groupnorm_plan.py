"""The GroupNorm kernels' schedule and its plain walk, held on the CPU.

``ops/fused_groupnorm.plan`` decides, from a call's shape and the SM count
alone, what ``csrc/group_norm.cu`` runs: the pixels a block covers side by
side, the stage of the shared-memory ring, the ring's depth, the chunks of
the statistics launch and the ranges of the apply launch.  The first part
holds the plan at every shape the gate admits on the SSD-1B and SDXL edit
paths at 1024² (batch 1 and 2, the GroupNorm kernel on, default and opt-in
conv configurations) and at tiny shapes, for several SM counts.  The second
part holds ``group_norm_chunked_plain`` and ``scale_shift_chunked_plain``,
plain PyTorch walks of the schedule (each stage's mean and centred M2, merged
per chunk and then across chunks with Chan's formula in the kernel's
order), and the plain ``group_norm_scale_shift``, against the JAX package's
``fused_group_norm`` in interpret mode, ``group_norm_xla`` and
``group_norm_scale_shift``, on numpy-seeded inputs in fp32 at the repo's
golden tolerance, rtol = atol = 2e-4; and shows that a one-pass merge of the
same partials (sums and sums of squares) fails that test where |mean| >> std.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastedit_tpu.ops import flags as jflags
from fastedit_tpu.ops import fused_groupnorm as jgn
from fastedit_tpu.ops.groupnorm import group_norm_scale_shift as jgn_scale_shift
from fastedit_tpu.ops.groupnorm import group_norm_xla

from fastedit_tpu_torch.models import configs as TC
from fastedit_tpu_torch.ops import fused_groupnorm as fg
from fastedit_tpu_torch.ops import flags as tflags
from fastedit_tpu_torch.ops.groupnorm import group_norm_scale_shift
from fastedit_tpu_torch.tools import inventory

TOL = dict(rtol=2e-4, atol=2e-4)  # the repo's golden tolerance, fp32
SMS = (132, 1, 7, 1000)  # the H100's, and schedules of one, a few and many chunks


def _inventory_shapes():
    """(B, H*W, C, G) of every GroupNorm and statistics call the inventory
    routes to the kernels with them on."""
    shapes = set()
    for unet in (TC.SSD1B_UNET, TC.SDXL_UNET):
        for batch in (1, 2):
            sites = inventory.edit_sites(unet, TC.SDXL_CONTROLNET_SMALL, TC.SDXL_VAE, 1024,
                                         batch=batch, steps=3)
            for conv in (None, True):
                with tflags.override(use_cuda_groupnorm=True, use_cuda_conv=conv):
                    calls = inventory.kernel_calls(sites)
                for (kernel, key), _ in calls.items():
                    if kernel.startswith("group_norm"):
                        n, h, w, c, g = key[:5]
                        shapes.add((n, h * w, c, g))
    return sorted(shapes)


INVENTORY = _inventory_shapes()
TINY = [(1, 63, 64, 8), (2, 143, 128, 32), (1, 1024, 64, 32), (2, 1, 2560, 32),
        (3, 17, 320, 32), (1, 1, 4096, 128)]


def test_inventory_reaches_the_plan():
    kinds = {(c, g) for _, _, c, g in INVENTORY}
    assert len(INVENTORY) >= 20 and {(128, 32), (320, 32), (1280, 32), (2560, 32)} <= kinds


def _covered_once(ranges, hw):
    seen = np.zeros(hw, dtype=int)
    for p0, p1 in ranges:
        assert 0 <= p0 < p1 <= hw
        seen[p0:p1] += 1
    return bool((seen == 1).all())


@pytest.mark.parametrize("sms", SMS)
def test_plan_covers_every_pixel_once_and_fits(sms):
    for b, hw, c, g in INVENTORY + TINY:
        p = fg.plan(b, hw, c, g, sms)
        assert p == fg.plan(b, hw, c, g, sms)  # a pure function of its arguments
        assert _covered_once(p.chunks(), hw) and _covered_once(p.apply_chunks(), hw)
        assert p.ntiles == -(-hw // p.tile_px) and p.tile_px == p.lanes * p.vecs
        assert (p.nchunk - 1) * p.tiles_per_chunk < p.ntiles <= p.nchunk * p.tiles_per_chunk
        assert p.apply_px % p.lanes == 0
        vc = c // 8
        assert p.lanes * vc <= fg.MAX_THREADS and p.threads % 32 == 0
        assert p.lanes * vc > fg.MAX_THREADS // 2 or p.lanes == 1
        assert p.threads >= g and p.threads >= p.lanes * vc
        assert 1 <= p.stages <= min(fg.MAX_STAGES, p.tiles_per_chunk)
        assert p.stages * p.stage_bytes <= fg.RING_BYTES
        assert p.smem_bytes <= fg.SMEM_LIMIT and p.stage_bytes % 16 == 0
        assert p.nchunk * g <= fg.MAX_CHANNELS  # the last block stages them all
        assert (p.threads // 32) * (32 // p.merge_lanes) >= g  # all groups in one round
        resident = p.stages == p.tiles_per_chunk and b * p.nchunk <= sms
        assert p.route == ("resident" if resident else "two_launch")


def test_plan_fills_the_card():
    """Every main-path shape gives the H100's 132 SMs a block each (within a
    chunk's rounding), except where the shape has fewer stages than SMs."""
    for b, hw, c, g in INVENTORY:
        p = fg.plan(b, hw, c, g)
        blocks = p.nchunk * b
        if b * p.ntiles >= 132:
            assert 0.6 * 132 <= blocks <= 132, (b, hw, c, p)
        assert p.napply * b >= min(132, b * -(-hw // p.lanes))


def test_both_routes_serve_the_main_path():
    """The denoise loop's small and middle shapes (up to 26 MB) go resident;
    the VAE's large ones take two launches."""
    routes = {(b, hw, c): fg.plan(b, hw, c, g).route for b, hw, c, g in INVENTORY}
    assert routes[(2, 32 * 32, 1280)] == routes[(2, 128 * 128, 320)] == "resident"
    assert routes[(1, 1024 * 1024, 128)] == routes[(2, 128 * 128, 640)] == "two_launch"


def test_plan_depends_on_the_sm_count():
    assert fg.plan(1, 4096, 640, 32, 132) != fg.plan(1, 4096, 640, 32, 8)
    with pytest.raises(ValueError):
        fg.plan(1, 64, 100, 10)  # channels no multiple of 8


# ------------------------------------------------------------ plain walk


def _inputs(shape, offset, spread, seed):
    r = np.random.default_rng(seed)
    x = (r.standard_normal(shape) * spread + offset).astype(np.float32)
    gamma = r.standard_normal(shape[-1]).astype(np.float32)
    beta = r.standard_normal(shape[-1]).astype(np.float32)
    return x, gamma, beta


# |mean| = 50 std: at larger ratios the fp32 references themselves (XLA's
# reductions) stray from the float64 result by more than the tolerance, while
# a one-pass variance already fails it here.
CASES = [  # shape, groups, act, offset, spread
    ((2, 7, 9, 64), 8, "silu", 0.0, 1.0),  # odd pixel count, 8 groups
    ((1, 13, 11, 128), 32, None, 0.0, 1.0),  # odd pixel count
    ((1, 32, 32, 64), 32, "silu", 0.0, 1.0),
    ((2, 5, 7, 320), 32, None, 50.0, 1.0),  # |mean| >> std
    ((1, 16, 16, 96), 8, "silu", 50.0, 1.0),  # |mean| >> std, 8 groups
    ((1, 9, 13, 128), 32, None, 50.0, 1.0),  # |mean| >> std, odd pixel count
]


@pytest.mark.parametrize("sms", [132, 3])
@pytest.mark.parametrize("shape,groups,act,offset,spread", CASES)
def test_chunked_plain_matches_jax(shape, groups, act, offset, spread, sms):
    x, gamma, beta = _inputs(shape, offset, spread, seed=sum(shape) + sms)
    with jflags.override(pallas_interpret=True):
        ref_kernel = jgn.fused_group_norm(jnp.asarray(x), jnp.asarray(gamma),
                                          jnp.asarray(beta), groups, 1e-6, act)
    ref_xla = group_norm_xla(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                             groups, 1e-6, act)
    out = fg.group_norm_chunked_plain(torch.from_numpy(x), torch.from_numpy(gamma),
                                      torch.from_numpy(beta), groups, 1e-6, act, sms=sms)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_kernel), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_xla), **TOL)


@pytest.mark.parametrize("sms", [132, 3])
@pytest.mark.parametrize("shape,groups,act,offset,spread", CASES)
def test_scale_shift_matches_jax(shape, groups, act, offset, spread, sms):
    """The statistics launch's walk and the plain version (what the
    dispatcher runs with the kernel off, or on a CPU tensor) against the JAX
    package's XLA ``group_norm_scale_shift``."""
    x, gamma, beta = _inputs(shape, offset, spread, seed=3 * sum(shape) + sms)
    rs, rsh = (np.asarray(a) for a in jgn_scale_shift(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), groups, 1e-6))
    args = (torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta), groups, 1e-6)
    walked = fg.scale_shift_chunked_plain(*args, sms=sms)
    with tflags.override(use_cuda_groupnorm=True):  # the dispatcher to the wrapper: plain on CPU
        dispatched = group_norm_scale_shift(*args)
    for scale, shift in (walked, dispatched):
        assert scale.dtype == shift.dtype == torch.float32
        np.testing.assert_allclose(scale.numpy(), rs, **TOL)
        # shift = beta - mean * scale cancels where |mean| >> std: the
        # absolute term of tests/test_torch_ops.py's scale-shift test there
        np.testing.assert_allclose(shift.numpy(), rsh, rtol=2e-4,
                                   atol=2e-3 if offset else 2e-4)


def _one_pass_merge(counts, mean, m2, lanes):
    """The same chunk partials merged one-pass, in fp32: total sums and sums
    of squares, var = E[x^2] - E[x]^2."""
    n = counts.float()[None, :, None]
    s = (n * mean).sum(1)
    q = (m2 + n * mean * mean).sum(1)
    total = n.sum(1)
    mu = s / total
    return mu.double(), (q / total - mu * mu).double()


@pytest.mark.parametrize("shape,groups,act,offset,spread", CASES[3:])
def test_a_one_pass_merge_fails_the_same_test(monkeypatch, shape, groups, act, offset, spread):
    sms = 3
    x, gamma, beta = _inputs(shape, offset, spread, seed=sum(shape) + sms)
    ref = group_norm_xla(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                         groups, 1e-6, act)
    monkeypatch.setattr(fg, "merge_chunks", _one_pass_merge)
    out = fg.group_norm_chunked_plain(torch.from_numpy(x), torch.from_numpy(gamma),
                                      torch.from_numpy(beta), groups, 1e-6, act, sms=sms)
    assert fg.plan(shape[0], shape[1] * shape[2], shape[3], groups, sms).nchunk > 1
    assert not np.allclose(out.numpy(), np.asarray(ref), **TOL)


def test_merge_takes_the_kernels_order():
    """Chunks 0 .. 69 over a group's run of lanes (16 of them: 16 warps take
    32 groups in one round): lane i merges i, i + 16, ... in turn, then the
    butterfly; the result equals the float64 statistics of the image within
    fp32 rounding, and the walk's partials cover it."""
    x, gamma, beta = _inputs((1, 64, 70, 64), 0.5, 2.0, seed=9)
    p = fg.plan(1, 4480, 64, 32, 140)
    assert p.nchunk == 70 and p.merge_lanes == 16
    counts, mean, m2 = fg.chunk_partials(torch.from_numpy(x), p)
    assert float(counts.sum()) == 4480 * 2
    mu, var = fg.merge_chunks(counts, mean, m2, p.merge_lanes)
    xd = torch.from_numpy(x).double().reshape(1, 4480, 32, 2)
    np.testing.assert_allclose(mu.numpy(), xd.mean((1, 3)).numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), xd.var((1, 3), unbiased=False).numpy(),
                               rtol=1e-5, atol=1e-6)
