"""The flash attention kernels' schedule, held on the CPU.

``ops/flash_attention.plan`` decides, from a call's shape alone, what
``csrc/flash_attention.cu`` runs: the q tile (at D = 64 128 or 192 rows: two
or three consumer warpgroups of 64 rows each) and the KV tile, the K and V
tiles in flight, the grid, the shared memory, the TMA box and the order in
which a persistent block walks its tiles.  The first half holds the plan at every
attention shape the gate admits on the SSD-1B and SDXL edit paths at 1024²
(batch 1, 2 and 4).  The second half holds ``attention_tiled_plain``, a plain
PyTorch walk of the same schedule (scale folded into q, online softmax per KV
tile, P rounded before P.V, one rounding of O / l), against the port's plain
version and against the JAX package's kernels in interpret mode, on
numpy-seeded inputs in fp32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastedit_tpu.ops import flags as jflags
from fastedit_tpu.ops import flash_attention as jfa

from fastedit_tpu_torch.models import configs as TC
from fastedit_tpu_torch.ops import conv3x3 as k
from fastedit_tpu_torch.ops import flash_attention as fa
from fastedit_tpu_torch.tools import inventory

TOL = dict(rtol=2e-4, atol=2e-4)  # the repo's golden tolerance, fp32
# The tiled walk and the plain version differ only in the order of fp32 sums
# of values below 1 and in exp(s - m) split over tiles.
ORDER_TOL = dict(rtol=1e-5, atol=1e-5)


def _attention_calls():
    """{model: {(B, Sq, Skv, H, D): calls per edit}} for the calls the gate
    admits, per UNet at batch 1, plus the shapes of batch 2 and 4."""
    per_model, shapes = {}, set()
    for name, unet in (("ssd-1b", TC.SSD1B_UNET), ("sdxl", TC.SDXL_UNET)):
        for batch in (1, 2):
            sites = inventory.edit_sites(unet, TC.SDXL_CONTROLNET_SMALL, TC.SDXL_VAE, 1024,
                                         batch=batch, steps=3)
            calls = {key: n for (kernel, key), n in inventory.kernel_calls(sites).items()
                     if kernel.startswith("flash_attention")}
            shapes.update(calls)
            if batch == 1:
                per_model[name] = calls
    return per_model, sorted(shapes)


CALLS, SHAPES = _attention_calls()


def test_inventory_reaches_the_plan():
    def d64(calls):
        return sum(n for key, n in calls.items() if key[4] == 64)

    # per edit: SSD-1B 78 + 24 calls at D = 64, SDXL 180 + 30, and the VAE's two at D = 512
    assert d64(CALLS["ssd-1b"]) == 102 and d64(CALLS["sdxl"]) == 210
    assert sorted(CALLS["ssd-1b"].values()) == [2, 24, 78]
    assert sorted(CALLS["sdxl"].values()) == [2, 30, 180]
    assert {s[4] for s in SHAPES} == {64, 512}
    assert {s[0] for s in SHAPES} >= {1, 2, 4}  # guidance doubles the UNet's batch


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_the_call(shape):
    b, sq, skv, h, d = shape
    assert fa.supports((b, sq, h, d), skv)
    pl = fa.plan(b, sq, skv, h, d)
    # whole KV tiles; q tiles of whole warpgroup slices that cover Sq once (a head's last
    # tile may reach past Sq, by whole slices: its loads zero-fill, its stores clip)
    assert pl.bq in fa.Q_TILES[d] and skv % pl.bkv == 0
    assert (pl.q_tiles, pl.kv_tiles) == (-(-sq // pl.bq), skv // pl.bkv)
    assert pl.tiles == b * h * pl.q_tiles
    if d == 64:
        assert pl.bq % fa.SLICE == 0 and sq % fa.SLICE == 0
    else:
        assert sq % pl.bq == 0
    # every (batch, head, q tile) is visited once
    t = np.arange(pl.tiles)
    tb, th, q0 = pl.tile_at(t)
    assert tb.min() == 0 and tb.max() == b - 1 and th.min() == 0 and th.max() == h - 1
    assert q0.min() == 0 and sq - pl.bq <= q0.max() < sq and (q0 % pl.bq == 0).all()
    assert len({*zip(tb.tolist(), th.tolist(), q0.tolist())}) == pl.tiles
    # the tile that needs the cheaper rounds on this card
    def cost(bq):
        return -(-(b * h * -(-sq // bq)) // k.H100_SMS) * bq * fa.ROW_COST[bq]
    assert all(cost(pl.bq) <= cost(other) for other in fa.Q_TILES[d])
    # resources
    assert pl.smem_bytes == fa.smem_bytes(d, pl.bq) <= k.SMEM_LIMIT
    if pl.persistent:
        assert 1 <= pl.grid == min(pl.tiles, k.H100_SMS)
        # blocks that run together share heads: the first grid's tiles span few of them
        heads_in_flight = len({*zip(tb[:pl.grid].tolist(), th[:pl.grid].tolist())})
        assert heads_in_flight <= -(-pl.grid // pl.q_tiles) + 1
    else:
        assert pl.grid == pl.tiles
    if d == 64:
        assert (pl.bkv, pl.stages) == (128, 4)
        assert pl.box == (64, 1, pl.bq, 1)  # one head, one image: rows of 128 bytes
        assert pl.box[0] * 2 == 128 and max(pl.box) <= 256


def test_plan_choices():
    """The main path's shapes on 132 SMs: rounds of tiles a block walks x
    rows a tile decide between two and three consumer warpgroups."""
    def choice(*shape, **kw):
        pl = fa.plan(*shape, **kw)
        return pl.bq, pl.tiles, pl.grid

    assert choice(2, 1024, 1024, 20, 64) == (192, 240, 132)  # 2 rounds of 192, not 3 of 128
    assert choice(2, 4096, 4096, 10, 64) == (128, 640, 132)  # 5 of 128, not 4 of 192
    assert choice(4, 1024, 1024, 20, 64) == (128, 640, 132)
    assert choice(4, 4096, 4096, 10, 64) == (192, 880, 132)  # 7 of 192, not 10 of 128
    assert choice(1, 128, 128, 2, 64) == (128, 2, 2)  # nothing to fill a third warpgroup with
    assert fa.plan(1, 128, 256, 2, 64, sms=4).grid == 2
    assert fa.plan(1, 256, 128, 8, 64, sms=4).grid == 4
    # 1024 rows are five tiles of 192 and one of 64: the last tile is partial
    assert choice(1, 1024, 128, 20, 64) == (192, 120, 120)
    pl = fa.plan(1, 16384, 16384, 1, 512)
    assert (pl.bq, pl.bkv, pl.grid, pl.persistent) == (32, 32, 512, False)
    assert pl.smem_bytes == 107_392
    assert (fa.smem_bytes(64, 128), fa.smem_bytes(64, 192)) == (165_024, 181_408)
    for bad in ((1, 160, 128, 1, 64), (1, 128, 64, 1, 64), (0, 128, 128, 1, 64),
                (1, 128, 128, 1, 96)):
        with pytest.raises(ValueError):
            fa.plan(*bad)


def test_tiles_are_walked_q_tile_fastest():
    pl = fa.plan(2, 512, 512, 3, 64)
    assert pl.q_tiles == 4 and pl.tiles == 24
    assert [pl.tile_at(t) for t in (0, 1, 4, 12)] == \
        [(0, 0, 0), (0, 0, pl.bq), (0, 1, 0), (1, 0, 0)]


# ------------------------------------------------- the schedule, in fp32


def _qkv(seed, b, sq, skv, h, d):
    r = np.random.default_rng(seed)
    return tuple(torch.from_numpy(r.standard_normal((b, s, h, d)).astype(np.float32))
                 for s in (sq, skv, skv))


SMALL = [
    (1, 128, 128, 1, 64),  # one tile, one KV tile
    (2, 256, 384, 3, 64),  # two q tiles, three KV tiles, Sq != Skv
    (1, 1024, 128, 20, 64),  # tiles of 192 rows, the sixth of each head a partial one
    (1, 128, 512, 2, 64),  # four KV tiles: the running max and sum move
    (1, 64, 96, 1, 512),  # the D = 512 kernel's 32-row tiles
]


@pytest.mark.parametrize("shape", SMALL, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("scale", [None, 0.3])
def test_tiled_walk_equals_attention_plain(shape, scale):
    q, kk, v = _qkv(30, *shape)
    # logits wide enough that the running max matters, not so wide that fp32
    # rounding of a 512-term score shows in a peaked softmax
    kk = kk * (2.0 if shape[4] == 64 else 0.25)
    out = fa.attention_tiled_plain(q, kk, v, scale)
    ref = fa.attention_plain(q, kk, v, scale)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **ORDER_TOL)


def test_tiled_walk_in_bf16_rounds_where_the_kernel_does():
    """In bf16 the walk folds the scale into q in bf16 and rounds P before
    P.V; it stays within bf16 rounding of the plain version."""
    q, kk, v = (t.bfloat16() for t in _qkv(31, 1, 256, 256, 2, 64))
    out, ref = fa.attention_tiled_plain(q, kk, v), fa.attention_plain(q, kk, v)
    assert out.dtype == torch.bfloat16
    rms = float(ref.float().square().mean().sqrt())
    d = (out.float() - ref.float()).abs()
    assert bool((d <= 2.0**-7 * ref.float().abs() + 2.0**-3 * rms).all())


def test_a_skipped_kv_tile_is_far_outside_the_order_of_the_sums():
    """What ``chip_smoke.py``'s planted fault looks like in the walk: one KV
    tile of the plan skipped, equal to the plain version on the shorter K and
    V."""
    q, kk, v = _qkv(32, 1, 128, 384, 2, 64)
    pl = fa.plan(1, 128, 384, 2, 64)
    short = fa.attention_tiled_plain(q, kk, v, kv_tiles_skipped=1)
    np.testing.assert_allclose(
        short.numpy(), fa.attention_plain(q, kk[:, :-pl.bkv], v[:, :-pl.bkv]).numpy(),
        **ORDER_TOL)
    assert float((short - fa.attention_plain(q, kk, v)).abs().max()) > 0.05


@pytest.mark.parametrize("shape", [(1, 128, 128, 2, 64), (2, 256, 256, 2, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_tiled_walk_matches_jax_flash_packed(shape):
    b, sq, skv, h, d = shape
    q, kk, v = _qkv(33, *shape)
    assert jfa.supports_packed((b, sq, h, d), skv, 4)  # the head-packed kernel serves it
    with jflags.override(pallas_interpret=True):
        ref = jfa.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, kk, v)))
    out = fa.attention_tiled_plain(q, kk, v)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_tiled_walk_matches_jax_flash_bhsd():
    shape = (1, 128, 128, 1, 512)
    q, kk, v = _qkv(34, *shape)
    assert not jfa.supports_packed((1, 128, 1, 512), 128, 4) and jfa.supports((1, 128, 1, 512), 128)
    with jflags.override(pallas_interpret=True):
        ref = jfa.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, kk, v)))
    out = fa.attention_tiled_plain(q, kk, v)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_wrapper_on_the_cpu_takes_the_plain_version():
    q, kk, v = _qkv(35, 1, 128, 128, 1, 64)
    before = dict(fa.launches)
    assert torch.equal(fa.flash_attention(q, kk, v), fa.attention_plain(q, kk, v))
    assert fa.launches == before
    with pytest.raises(ValueError):
        fa.plan_for(q, 128)  # a plan for a card's SM count needs a tensor on a card
