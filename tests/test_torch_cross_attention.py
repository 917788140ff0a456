"""The cross-attention kernel's gate, schedule and routing, held on the CPU.

``ops/flash_attention.supports_cross`` admits the UNet's cross-attention to
the 77 text tokens in bf16 (every key in one KV tile); ``plan_cross`` decides
what ``flash_d64_kernel_cross`` in ``csrc/flash_attention.cu`` runs (the q
tile, the one KV tile, the persistent blocks' walk, heads fastest);
``attention_cross_tiled_plain`` walks that schedule in plain PyTorch: the
padded keys masked, the softmax exact in one pass, P normalised in fp32 and
then rounded to bf16.  The walk is held against the port's plain version and
the JAX package's ``attention_xla`` (what the JAX package runs for these
calls), and two planted faults (the padded keys left in the softmax, P
rounded before it is normalised) must fail the same limits.  The kernel
itself runs on the card only (``tests/test_torch_cuda.py``).
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastedit_tpu.ops.attention import attention_xla

from fastedit_tpu_torch.models import configs as TC
from fastedit_tpu_torch.ops import conv3x3 as k
from fastedit_tpu_torch.ops import flags
from fastedit_tpu_torch.ops import flash_attention as fa
from fastedit_tpu_torch.ops.attention import attention
from fastedit_tpu_torch.tools import inventory
from fastedit_tpu_torch.utils import profiling

BF16, F32 = torch.bfloat16, torch.float32
TEXT = inventory.TEXT_TOKENS
# The walk against a bf16 reference: both round P and O to bf16 at the same
# points and differ only in the order of fp32 sums and in exp's argument, so
# an element differs only where a sum lands on a bf16 rounding boundary (on
# the shapes below at most 0.02% of the elements, by one or a few LSB).
# Rounding P before normalising it moves ~48% of them, unmasked padded keys
# ~99%.
DIFFER_SHARE = 0.005
REL, ABS_OF_RMS = 2.0**-7, 2.0**-6


def _cross_sites(unet, batch):
    sites = inventory.edit_sites(unet, TC.SDXL_CONTROLNET_SMALL, TC.SDXL_VAE, 1024,
                                 batch=batch, steps=3)
    return {key: n for (_, op, key), n in sites.items() if op == "attn" and key[2] == TEXT}


CROSS = {(name, batch): _cross_sites(unet, batch)
         for name, unet in (("ssd-1b", TC.SSD1B_UNET), ("sdxl", TC.SDXL_UNET))
         for batch in (1, 2, 4)}
CROSS_SHAPES = sorted({key for calls in CROSS.values() for key in calls})


def _ids(s):
    return "x".join(map(str, s))


# ------------------------------------------------- the gate


@pytest.mark.parametrize("shape", CROSS_SHAPES, ids=_ids)
def test_the_gate_takes_every_unet_cross_attention_in_bf16(shape):
    """SSD-1B's and SDXL's cross-attention at 2, 4 and 8 rows (an edit, a
    batch of two and the sweep's four, under CFG): the kernel in bf16, the
    plain version in fp32."""
    b, sq, skv, h, d = shape
    assert b in (2, 4, 8) and skv == TEXT and d == 64
    assert fa.supports_cross((b, sq, h, d), skv, BF16)
    assert not fa.supports((b, sq, h, d), skv)
    assert inventory.route("attn", shape) == [("cross_attention", shape)]
    assert inventory.route("attn", shape, F32) == []
    for stage in flags.STAGES:
        with flags.stage(stage):
            assert inventory.route("attn", shape) == [("cross_attention", shape)]


def test_the_cross_shapes_and_their_calls_per_edit():
    """Per edit: SSD-1B 34 cross-attention calls a forward (8 at 64² with 10
    heads, 26 at 32² with 20), SDXL 70 (10 and 60), three steps."""
    for batch in (1, 2, 4):
        rows = 2 * batch
        assert CROSS[("ssd-1b", batch)] == {(rows, 4096, TEXT, 10, 64): 24,
                                            (rows, 1024, TEXT, 20, 64): 78}
        assert CROSS[("sdxl", batch)] == {(rows, 4096, TEXT, 10, 64): 30,
                                          (rows, 1024, TEXT, 20, 64): 180}
    for name, per_edit in (("ssd-1b", 102), ("sdxl", 210)):
        unet = TC.SSD1B_UNET if name == "ssd-1b" else TC.SDXL_UNET
        sites = inventory.edit_sites(unet, TC.SDXL_CONTROLNET_SMALL, TC.SDXL_VAE, 1024)
        bf16 = inventory.launches_by_kernel(inventory.kernel_calls(sites))
        f32 = inventory.launches_by_kernel(inventory.kernel_calls(sites, F32))
        assert bf16["cross_attention"] == per_edit
        assert bf16["flash_attention_d64"] == per_edit  # self-attention, unchanged
        assert "cross_attention_f32" not in f32
        assert f32["flash_attention_d64_f32"] == per_edit


@pytest.mark.parametrize("shape,dtype,why", [
    ((2, 77, 12, 64), BF16, "CLIP ViT-L's self-attention: Sq 77"),
    ((2, 77, 20, 64), BF16, "CLIP bigG's: Sq 77"),
    ((8, 4096, 10, 64), F32, "fp32: the quality mode keeps the plain version"),
    ((8, 1024, 20, 64), torch.float16, "fp16"),
    ((8, 4096, 5, 128), BF16, "D 128"),
    ((8, 4096, 1, 512), BF16, "D 512"),
    ((2, 4096, 10, 64), BF16, "Skv 128: the flash kernel's"),
    ((2, 4096, 10, 64), BF16, "Skv 0"),
    ((2, 96, 10, 64), BF16, "Sq 96: fewer than 128 rows"),
    ((2, 1000, 10, 64), BF16, "Sq 1000: no multiple of 64"),
    ((2, 4096, 10), BF16, "not BSHD"),
], ids=lambda x: x if isinstance(x, str) else None)
def test_the_gate_refuses(shape, dtype, why):
    skv = {"Skv 128: the flash kernel's": 128, "Skv 0": 0}.get(why, TEXT)
    assert not fa.supports_cross(shape, skv, dtype)


def test_the_gate_refuses_the_tiny_model():
    sites = inventory.edit_sites(TC.TINY_UNET, TC.TINY_CONTROLNET, TC.TINY_VAE, 64)
    attn = [key for (_, op, key) in sites if op == "attn"]
    assert attn and not any(fa.supports_cross((b, sq, h, d), skv, BF16)
                            for b, sq, skv, h, d in attn)
    assert not inventory.launches_by_kernel(inventory.kernel_calls(sites))["cross_attention"]


@pytest.mark.parametrize("skv", [1, 76, 77, 80, 81, 127])
def test_the_gate_takes_one_kv_tile_of_keys(skv):
    assert fa.supports_cross((2, 1024, 20, 64), skv, BF16)
    assert fa.plan_cross(2, 1024, skv, 20, 64).bkv == (80 if skv <= 80 else 128)


def test_self_attention_keeps_its_plan_and_its_route():
    """The self-attention calls keep the flash kernel and the plan they had:
    the q tile from the same rounds of tiles, the same grid and memory."""
    def choice(*shape):
        pl = fa.plan(*shape)
        return pl.bq, pl.bkv, pl.tiles, pl.grid, pl.smem_bytes

    assert choice(2, 1024, 1024, 20, 64) == (192, 128, 240, 132, 181_408)
    assert choice(2, 4096, 4096, 10, 64) == (128, 128, 640, 132, 165_024)
    assert choice(4, 4096, 4096, 10, 64) == (192, 128, 880, 132, 181_408)
    assert choice(4, 1024, 1024, 20, 64) == (128, 128, 640, 132, 165_024)
    assert choice(8, 4096, 4096, 10, 64) == (192, 128, 1760, 132, 181_408)
    assert choice(8, 1024, 1024, 20, 64) == (128, 128, 1280, 132, 165_024)
    assert choice(1, 16384, 16384, 1, 512) == (64, 64, 256, 132, 231_248)
    assert choice(4, 16384, 16384, 1, 512) == (64, 64, 1024, 132, 231_248)
    for shape in ((8, 4096, 4096, 10, 64), (8, 1024, 1024, 20, 64)):
        b, sq, skv, h, d = shape
        assert inventory.route("attn", shape) == [("flash_attention_d64", shape)]
        assert not fa.supports_cross((b, sq, h, d), skv, BF16)


# ------------------------------------------------- the schedule


@pytest.mark.parametrize("shape", CROSS_SHAPES, ids=_ids)
def test_plan_cross_covers_the_call(shape):
    """Every tile once, in strided shares that differ by one tile at most;
    the q tile as the self-attention plan picks it; 80 keys a KV tile; the
    shared memory within what a block may use."""
    b, sq, skv, h, d = shape
    pl = fa.plan_cross(b, sq, skv, h, d)
    assert pl.bq == fa.plan(b, sq, 128, h, d).bq and pl.bkv == 80
    assert pl.q_tiles == -(-sq // pl.bq) and pl.tiles == b * h * pl.q_tiles
    assert pl.grid == min(pl.tiles, k.H100_SMS)
    shares = [pl.tiles_of(i) for i in range(pl.grid)]
    assert sorted(t for r in shares for t in r) == list(range(pl.tiles))
    assert max(map(len, shares)) - min(map(len, shares)) <= 1
    assert pl.smem_bytes == fa.smem_bytes_cross(pl.bq, pl.bkv) <= k.SMEM_LIMIT
    # heads fastest: the tiles the blocks take together read whole rows of q
    walk = [pl.tile_at(t) for t in range(pl.tiles)]
    assert walk[:h] == [(0, hi, 0) for hi in range(h)]
    assert sorted(walk) == sorted((bi, hi, qt * pl.bq) for bi in range(b) for hi in range(h)
                                  for qt in range(pl.q_tiles))
    for first in range(0, pl.tiles - pl.grid + 1, pl.grid):  # one round of the blocks
        rows = {(bi, q0) for bi, _, q0 in walk[first:first + pl.grid]}
        assert len(rows) <= -(-pl.grid // h) + 1


def test_plan_cross_choices():
    def choice(*shape, **kw):
        pl = fa.plan_cross(*shape, **kw)
        return pl.bq, pl.bkv, pl.tiles, pl.grid, pl.smem_bytes

    # Q ring 4 x bq x 128 B, K and V rings 4 x bkv x 128 B each, 16 mbarriers
    assert choice(8, 4096, 77, 10, 64) == (192, 80, 1760, 132, 181_376)
    assert choice(8, 1024, 77, 20, 64) == (128, 80, 1280, 132, 148_608)
    assert choice(2, 4096, 77, 10, 64) == (128, 80, 640, 132, 148_608)
    assert choice(2, 1024, 77, 20, 64) == (192, 80, 240, 132, 181_376)
    assert choice(4, 4096, 77, 10, 64) == (192, 80, 880, 132, 181_376)
    assert choice(1, 128, 100, 1, 64) == (128, 128, 1, 1, 197_760)
    assert fa.smem_bytes_cross(192, 128) == 230_528 <= k.SMEM_LIMIT  # the largest instance
    assert fa.plan_cross(8, 4096, 77, 10, 64, sms=100).grid == 100
    for bad in ((1, 96, 77, 1, 64), (1, 160, 77, 1, 64), (1, 128, 0, 1, 64),
                (1, 128, 129, 1, 64), (1, 128, 77, 1, 128), (0, 128, 77, 1, 64)):
        with pytest.raises(ValueError):
            fa.plan_cross(*bad)


def _qkv(seed, b, sq, skv, h, dtype=BF16, k_scale=2.0):
    r = np.random.default_rng(seed)
    q, kk, v = (torch.from_numpy(r.standard_normal((b, s, h, 64)).astype(np.float32))
                for s in (sq, skv, skv))
    return q.to(dtype), (kk * k_scale).to(dtype), v.to(dtype)


def _differ(out, ref):
    """(share of elements that differ, whether every element is within the
    limit): bf16 rounding of P and O at the same points agrees nearly
    everywhere; the elementwise limit is the kernel tests' shape."""
    d = (out.float() - ref.float()).abs()
    rms = float(ref.float().square().mean().sqrt())
    return float((d > 0).float().mean()), bool((d <= REL * ref.float().abs()
                                                + ABS_OF_RMS * rms).all())


WALK = [
    (2, 256, 77, 3),  # two tiles of 128 a head, 80-key tile, heads fastest
    (1, 1024, 77, 2),  # 192-row tiles, each head's last a partial one
    (2, 192, 100, 2),  # the 128-key tile
    (1, 128, 1, 1),  # one key: P is 1
]


@pytest.mark.parametrize("shape", WALK, ids=_ids)
@pytest.mark.parametrize("scale", [None, 0.3])
def test_tiled_walk_equals_attention_plain(shape, scale):
    q, kk, v = _qkv(40, *shape)
    out, ref = fa.attention_cross_tiled_plain(q, kk, v, scale), fa.attention_plain(q, kk, v, scale)
    assert out.dtype == BF16 and out.shape == q.shape
    share, close = _differ(out, ref)
    assert close and share <= DIFFER_SHARE


@pytest.mark.parametrize("shape", WALK[:3], ids=_ids)
def test_tiled_walk_matches_jax_attention_xla(shape):
    """What the JAX package runs for these calls: XLA's einsums in fp32 on
    bf16 operands, an fp32 softmax, P rounded to bf16."""
    q, kk, v = _qkv(41, *shape)
    ref = attention_xla(*(jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
                          for t in (q, kk, v)))
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    share, close = _differ(fa.attention_cross_tiled_plain(q, kk, v), ref)
    assert close and share <= DIFFER_SHARE


@pytest.mark.parametrize("fault", ["unmasked", "round_first"])
@pytest.mark.parametrize("shape", WALK[:3], ids=_ids)
def test_planted_faults_fail(shape, fault):
    """The padded keys left in the softmax (exp(0 - max) each), and P rounded
    to bf16 before it is normalised (O divided by the sum at the end, the
    flash kernels' order): each moves far more elements than the limit."""
    q, kk, v = _qkv(42, *shape)
    share, _ = _differ(fa.attention_cross_tiled_plain(q, kk, v, **{fault: True}),
                       fa.attention_plain(q, kk, v))
    assert share > 20 * DIFFER_SHARE


# ------------------------------------------------- dispatch and counters


def test_dispatch_sends_bf16_cross_attention_to_the_wrapper(monkeypatch):
    """On the CPU the wrapper returns the plain version; the dispatcher calls
    it for bf16 cross shapes, not for fp32 nor with the kernels off, and
    counts nothing off the card."""
    calls = Counter()
    real = fa.cross_attention

    def rec(*args, **kwargs):
        calls["cross"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(fa, "cross_attention", rec)
    q, kk, v = _qkv(43, 2, 128, TEXT, 2)
    before = (fa.cross_launches, profiling.counters().get("attention.plain_on_card", 0))
    assert torch.equal(attention(q, kk, v), fa.attention_plain(q, kk, v))
    assert calls["cross"] == 1
    attention(q.float(), kk.float(), v.float())
    with flags.override(plain_versions=True):
        attention(q, kk, v)
    assert calls["cross"] == 1
    assert (fa.cross_launches, profiling.counters().get("attention.plain_on_card", 0)) == before


def test_the_wrapper_never_takes_the_plain_version_off_the_cpu():
    """Off the CPU it launches the kernel or raises: here (meta tensors, no
    card, no nvcc) it must raise and count nothing, in or outside its gate."""
    before = inventory.launch_counts()
    for dtype, skv in ((BF16, TEXT), (F32, TEXT), (BF16, 128)):
        q = torch.empty((2, 128, 2, 64), dtype=dtype, device="meta")
        kv = torch.empty((2, skv, 2, 64), dtype=dtype, device="meta")
        with pytest.raises((RuntimeError, ValueError, TypeError, NotImplementedError)):
            fa.cross_attention(q, kv, kv)
    assert inventory.launch_counts() == before


def test_the_launch_counter_is_its_own():
    """K2's counts stay as they were: the cross kernel counts apart, under
    its inventory name, and a reset clears it."""
    assert "cross_attention" in inventory.BF16_KERNELS
    assert inventory.BF16_ONLY == ("cross_attention",)
    assert "cross_attention" in inventory.KERNELS
    assert "cross_attention_f32" not in inventory.KERNELS
    old = fa.cross_launches
    try:
        fa.cross_launches = 5
        counts = inventory.launch_counts()
        assert counts["cross_attention"] == 5 and counts["flash_attention_d64"] == fa.launches[64]
        inventory.reset_launch_counts()
        assert fa.cross_launches == 0 and not any(inventory.launch_counts().values())
    finally:
        fa.cross_launches = old
