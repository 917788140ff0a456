"""The GroupNorm kernel's schedule and its plain walk, held on the CPU.

``ops/fused_groupnorm.plan`` decides, from a call's shape, the blocks the
card holds at once, the item size and the cluster size alone, what
``csrc/group_norm.cu`` runs: the pixels a block covers side by side, the
stage of the shared-memory ring, the ring's depth, the chunks, the clusters
and the route (the chunk held whole by the ring, or in part read again).
The first part holds the plan at every shape the gate admits on the SSD-1B
and SDXL edit paths at 1024² (batch 1 and 2, by the kernel plan and with
the VAE encoder on the conv kernels) and at tiny shapes, at item sizes 2
and 4, for several counts of resident blocks and two cluster sizes.  The
second part holds ``group_norm_chunked_plain`` and
``scale_shift_chunked_plain``, plain PyTorch walks of the schedule (each
stage's mean and centred M2, merged per chunk, then per cluster, then across
the batch item's clusters with Chan's formula in the kernel's order), and
the plain ``group_norm_scale_shift``, against the JAX package's
``fused_group_norm`` in interpret mode, ``group_norm_xla`` and
``group_norm_scale_shift``, on numpy-seeded inputs in fp32 at the repo's
golden tolerance, rtol = atol = 2e-4; and shows that a one-pass merge of the
same partials (sums and sums of squares) fails that test where |mean| >> std.
"""

import functools

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
from fastedit_tpu_torch.ops.groupnorm import group_norm_scale_shift
from fastedit_tpu_torch.tools import inventory
from test_torch_fused import with_the_encoder_on_the_kernels

TOL = dict(rtol=2e-4, atol=2e-4)  # the repo's golden tolerance, fp32
# resident blocks: the H100's SMs, what it holds in clusters of 8 and of 16,
# and schedules of one block per batch item, a few and many
SMS = (132, 120, 112, 4, 7, 1000)
CLUSTERS = (8, 16)


def _inventory_shapes():
    """(B, H*W, C, G) of every GroupNorm and statistics call the inventory
    routes to the kernels, by the plan and with the VAE encoder on the conv
    kernels (its resnets' norms on the statistics launch)."""
    shapes = set()
    for unet in (TC.SSD1B_UNET, TC.SDXL_UNET):
        for batch in (1, 2):
            sites = inventory.edit_sites(unet, TC.SDXL_CONTROLNET_SMALL, TC.SDXL_VAE, 1024,
                                         batch=batch, steps=3)
            for routed in (sites, with_the_encoder_on_the_kernels(sites)):
                calls = inventory.kernel_calls(routed)
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


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("sms", SMS)
def test_plan_covers_every_pixel_once_and_fits(sms, itemsize, cluster):
    for b, hw, c, g in INVENTORY + TINY:
        p = fg.plan(b, hw, c, g, sms, itemsize, cluster)
        assert p == fg.plan(b, hw, c, g, sms, itemsize, cluster)  # a pure function
        assert _covered_once(p.chunks(), hw)
        assert p.ntiles == -(-hw // p.tile_px) and p.tile_px == p.lanes * p.vecs
        tiles = [t1 - t0 for t0, t1 in map(p.chunk_tiles, range(p.nchunk))]
        assert min(tiles) >= 1 and max(tiles) - min(tiles) <= 1 and max(tiles) == p.max_tiles
        assert sum(tiles) == p.ntiles
        # clusters: whole, within the limits, and every block resident at once
        assert p.cluster in (1, 2, 4, 8, 16) and p.cluster <= cluster
        assert p.nchunk % p.cluster == 0 and b * p.nchunk <= sms
        assert p.nclusters * g <= fg.MAX_CHANNELS  # the barrier stages them all
        assert p.nclusters <= fg.MAX_PARTIALS
        assert p.route == "resident" or p.stages >= 3  # the apply's jobs take three stages
        vc = c // 8
        assert p.lanes * vc <= fg.MAX_THREADS and p.threads % 32 == 0
        assert p.lanes * vc > fg.MAX_THREADS // 2 or p.lanes == 1
        assert p.threads >= g and p.threads >= p.lanes * vc
        assert p.vecs in fg.VECS[itemsize] and p.stage_bytes == p.tile_px * c * itemsize
        assert 1 <= p.stages <= min(fg.MAX_STAGES, p.max_tiles)
        assert p.stages * p.stage_bytes <= fg.RING_BYTES
        assert p.smem_bytes <= fg.SMEM_LIMIT and p.stage_bytes % 16 == 0
        assert (p.threads // 32) * (32 // p.merge_lanes) >= g  # all groups in one round
        assert p.route == ("resident" if p.max_tiles <= p.stages else "reread")
        assert (p.reread_bytes == 0) == (p.route == "resident")


@pytest.mark.parametrize("itemsize", [2, 4])
def test_plan_fills_the_card(itemsize):
    """Every main-path shape gives the blocks the H100 holds in clusters of 8
    (120) a chunk each, but for fewer than a cluster's worth left out, except
    where the shape has fewer stages or the barrier's partials run out."""
    for b, hw, c, g in INVENTORY:
        p = fg.plan(b, hw, c, g, 120, itemsize)
        most = min(120 // b, p.ntiles, fg.MAX_PARTIALS * p.cluster)
        assert most - p.cluster < p.nchunk <= most, (b, hw, c, p)


def test_both_routes_serve_the_main_path():
    """One launch per call on either route.  The denoise loop's small and
    middle shapes are resident (x read once) in bf16, the VAE's large ones
    read in part again; in fp32, where a stage holds half the pixels, the
    middle ones are read in part again too."""
    routes = {(b, hw, c, isz): fg.plan(b, hw, c, g, 120, isz).route
              for b, hw, c, g in INVENTORY for isz in (2, 4)}
    assert set(routes.values()) == {"resident", "reread"}
    assert routes[(2, 32 * 32, 1280, 2)] == routes[(2, 128 * 128, 320, 2)] == "resident"
    assert routes[(2, 32 * 32, 1280, 4)] == "resident"
    assert routes[(1, 1024 * 1024, 128, 2)] == routes[(2, 128 * 128, 640, 2)] == "reread"
    assert routes[(2, 128 * 128, 320, 4)] == routes[(1, 128 * 128, 512, 4)] == "reread"
    for (b, hw, c, isz), route in routes.items():  # fp32 keeps no more on chip than bf16
        assert isz == 2 or route == "reread" or routes[(b, hw, c, 2)] == "resident"
    # the VAE's largest calls, bound by bytes, take clusters of 2 over all 132 SMs
    # (plan_for's wide clusters); the small ones a launch without clusters
    assert fg.plan(1, 1024 * 1024, 128, 32, 132, 4, fg.WIDE_CLUSTER).cluster == 2
    assert fg.plan(2, 32 * 32, 1280, 32, 120, 2).cluster == 1


def test_plan_depends_on_the_sm_count():
    assert fg.plan(1, 4096, 640, 32, 132) != fg.plan(1, 4096, 640, 32, 8)
    assert fg.plan(1, 16384, 512, 32, 120, 2, 8).cluster == 8  # and the cluster size
    assert fg.plan(1, 16384, 512, 32, 120, 2, 2).cluster <= 2
    with pytest.raises(ValueError):
        fg.plan(1, 64, 100, 10)  # channels no multiple of 8
    with pytest.raises(ValueError):
        fg.plan(4, 64, 64, 32, 3)  # fewer resident blocks than batch items
    with pytest.raises(ValueError):
        fg.plan(1, 64, 64, 32, 132, 2, 3)  # no cluster of 3


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


@functools.lru_cache(maxsize=None)
def _jax_group_norm(case: int, seed: int):
    """The JAX package's kernel in interpret mode and its XLA GroupNorm on
    CASES[case] made from ``seed`` (numpy arrays; shared by the cluster
    sizes)."""
    shape, groups, act, offset, spread = CASES[case]
    x, gamma, beta = (jnp.asarray(a) for a in _inputs(shape, offset, spread, seed))
    with jflags.override(pallas_interpret=True):
        ref_kernel = jgn.fused_group_norm(x, gamma, beta, groups, 1e-6, act)
    return np.asarray(ref_kernel), np.asarray(group_norm_xla(x, gamma, beta, groups, 1e-6, act))


def _clusters(monkeypatch, cluster):
    """Clusters of 8 as the plan weighs them, or of 2 wherever they fit (the
    plan uncached while its constants are patched)."""
    if cluster == 2:
        monkeypatch.setattr(fg, "plan", fg.plan.__wrapped__)
        monkeypatch.setattr(fg, "CLUSTER_COST_BYTES", 0)


@pytest.mark.parametrize("cluster", [8, 2])
@pytest.mark.parametrize("sms", [132, 3])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_chunked_plain_matches_jax(monkeypatch, case, sms, cluster):
    _clusters(monkeypatch, cluster)
    shape, groups, act, offset, spread = CASES[case]
    x, gamma, beta = _inputs(shape, offset, spread, seed=sum(shape) + sms)
    ref_kernel, ref_xla = _jax_group_norm(case, sum(shape) + sms)
    out = fg.group_norm_chunked_plain(torch.from_numpy(x), torch.from_numpy(gamma),
                                      torch.from_numpy(beta), groups, 1e-6, act, sms=sms,
                                      cluster=cluster)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref_kernel, **TOL)
    np.testing.assert_allclose(out.numpy(), ref_xla, **TOL)


@pytest.mark.parametrize("cluster", [8, 2])
@pytest.mark.parametrize("sms", [132, 3])
@pytest.mark.parametrize("shape,groups,act,offset,spread", CASES)
def test_scale_shift_matches_jax(monkeypatch, shape, groups, act, offset, spread, sms,
                                 cluster):
    """The statistics' walk and the plain version (what the dispatcher runs
    with the kernel off, or on a CPU tensor) against the JAX package's XLA
    ``group_norm_scale_shift``."""
    _clusters(monkeypatch, cluster)
    x, gamma, beta = _inputs(shape, offset, spread, seed=3 * sum(shape) + sms)
    rs, rsh = (np.asarray(a) for a in jgn_scale_shift(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), groups, 1e-6))
    args = (torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta), groups, 1e-6)
    walked = fg.scale_shift_chunked_plain(*args, sms=sms, cluster=cluster)
    dispatched = group_norm_scale_shift(*args)  # the dispatcher to the wrapper: plain on CPU
    for scale, shift in (walked, dispatched):
        assert scale.dtype == shift.dtype == torch.float32
        np.testing.assert_allclose(scale.numpy(), rs, **TOL)
        # shift = beta - mean * scale cancels where |mean| >> std: the
        # absolute term of tests/test_torch_ops.py's scale-shift test there
        np.testing.assert_allclose(shift.numpy(), rsh, rtol=2e-4,
                                   atol=2e-3 if offset else 2e-4)


def _one_pass_merge(counts, mean, m2, lanes):
    """The same partials merged one-pass, in fp32: total sums and sums of
    squares, var = E[x^2] - E[x]^2."""
    n = counts.float()[None, :, None]
    s = (n * mean).sum(1)
    q = (m2 + n * mean * mean).sum(1)
    total = n.sum(1)
    mu = s / total
    return mu.double(), (q / total - mu * mu).double()


def _one_pass_clusters(counts, mean, m2, p):
    """Each cluster's chunk partials merged one-pass, in fp32, M2 = sum of
    (M2_k + n_k mean_k^2) - n mean^2."""
    n = counts.float().reshape(1, p.nclusters, p.cluster, 1)
    mean = mean.reshape(p.b, p.nclusters, p.cluster, -1)
    s = (n * mean).sum(2)
    q = (m2.reshape(mean.shape) + n * mean * mean).sum(2)
    total = n.sum(2)
    mu = s / total
    return counts.reshape(p.nclusters, p.cluster).sum(1), mu, q - total * mu * mu


@pytest.mark.parametrize("shape,groups,act,offset,spread", CASES[3:])
def test_a_one_pass_merge_fails_the_same_test(monkeypatch, shape, groups, act, offset, spread):
    """The merges above the chunks (the cluster's, the batch item's) taken
    one-pass, on the chunk partials the kernel forms: the walk fails the
    golden tolerance where |mean| >> std."""
    sms, cluster = 3, 2
    x, gamma, beta = _inputs(shape, offset, spread, seed=sum(shape) + sms)
    ref = group_norm_xla(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                         groups, 1e-6, act)
    monkeypatch.setattr(fg, "merge_chunks", _one_pass_merge)
    monkeypatch.setattr(fg, "cluster_partials", _one_pass_clusters)
    out = fg.group_norm_chunked_plain(torch.from_numpy(x), torch.from_numpy(gamma),
                                      torch.from_numpy(beta), groups, 1e-6, act, sms=sms,
                                      cluster=cluster)
    p = fg.plan(shape[0], shape[1] * shape[2], shape[3], groups, sms, 4, cluster)
    assert p.b * p.nchunk > 1  # several blocks' partials through the one-pass merges
    assert not np.allclose(out.numpy(), np.asarray(ref), **TOL)


def test_merge_takes_the_kernels_order(monkeypatch):
    """Chunks 0 .. 63 in 8 clusters of 8, over a group's run of lanes (16 of
    them: 16 warps take 32 groups in one round): lane i merges entries i, i +
    16, ... in turn, then the butterfly, for a block's lanes, a cluster's
    chunks and the batch item's clusters; the result equals the float64
    statistics of the image within fp32 rounding, and the walk's partials
    cover it."""
    x, gamma, beta = _inputs((1, 64, 70, 64), 0.5, 2.0, seed=9)
    monkeypatch.setattr(fg, "plan", fg.plan.__wrapped__)  # uncached while patched
    monkeypatch.setattr(fg, "CLUSTER_COST_BYTES", 0)  # clusters wherever they fit
    p = fg.plan(1, 4480, 64, 32, 64, 4, 8)
    assert (p.nchunk, p.cluster, p.nclusters, p.merge_lanes) == (64, 8, 8, 16)
    counts, mean, m2 = fg.chunk_partials(torch.from_numpy(x), p)
    assert float(counts.sum()) == 4480 * 2 and counts.shape == (64,)
    ccounts, cmean, cm2 = fg.cluster_partials(counts, mean, m2, p)
    assert ccounts.shape == (8,) and cmean.shape == cm2.shape == (1, 8, 32)
    assert torch.equal(ccounts, counts.reshape(8, 8).sum(1))
    mu, var = fg.merge_chunks(ccounts, cmean, cm2, p.merge_lanes)
    xd = torch.from_numpy(x).double().reshape(1, 4480, 32, 2)
    np.testing.assert_allclose(mu.numpy(), xd.mean((1, 3)).numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), xd.var((1, 3), unbiased=False).numpy(),
                               rtol=1e-5, atol=1e-6)
