"""A spec for ``tools/kernel_variants.py``: the cross-attention kernel
(``flash_d64_kernel_cross``) as built (tiles heads fastest, strided by the
grid, a K / V stage a tile), its first design (each block on a contiguous
range of tiles q tile fastest, K and V loaded once a head into a ring of two),
its warpgroups issuing S in turns, and timing-only cuts that say what bounds
it: the exps taken out of the softmax (``no_exp``) and both products taken
out (q copied through the ring to O, the walk's floor of bytes); each at q
tiles of 128 and 192 rows, at the UNet's cross shapes for the sweep's 8 rows
and an edit's 2, the inputs in four copies called in turn (L2 cold, as in an
edit).

    python fastedit_tpu_torch/tools/kernel_variants.py \
        fastedit_tpu_torch/tools/variants_flash_cross.py
"""

LIBRARY = "flash_attention"

VARIANTS = {
    "as_built": [],
    "contiguous_ranges": [
        ("constexpr int Q_STAGES = 4, KV_STAGES = 4;",
         "constexpr int Q_STAGES = 4, KV_STAGES = 2;"),
        ("    h = t % p.H;\n    q0 = (t / p.H % p.q_tiles) * BQ;\n    b = t / p.H / p.q_tiles;\n"
         "    bh = b * p.H + h;\n  };\n",
         "    bh = t / p.q_tiles;\n    q0 = (t - bh * p.q_tiles) * BQ;\n    b = bh / p.H;\n"
         "    h = bh - b * p.H;\n  };\n"
         "  const int first = static_cast<int>(static_cast<long long>(blockIdx.x) * p.tiles / "
         "gridDim.x);\n"
         "  const int last = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * p.tiles / "
         "gridDim.x);\n"),
        ("for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {\n      int bh, b, h, q0;",
         "for (int t = first; t < last; ++t) {\n      int bh, b, h, q0;"),
        ("      const int next = t + gridDim.x;  "
         "// K and V stay for the next tile of the same head\n"
         "      if (lane == 0 && (next >= p.tiles || next / p.H / p.q_tiles * p.H + next % p.H != "
         "bh))",
         "      if (lane == 0 && (t + 1 == last || (t + 1) / p.q_tiles != bh))")],
    # the warpgroups issue S in turns (flash_d64_kernel's named barriers 4 + cw),
    # so that one's softmax runs under the next one's product
    "turns": [("      // S = Q K^T, fp32.\n      wgmma_fence();",
               "      // S = Q K^T, fp32.\n"
               "      asm volatile(\"bar.sync %0, 256;\\n\" ::\"r\"(4 + cw) : \"memory\");\n"
               "      wgmma_fence();"),
              ("      wgmma_commit();\n      wgmma_wait<0>();\n\n      // The softmax of each row",
               "      wgmma_commit();\n"
               "      asm volatile(\"bar.arrive %0, 256;\\n\" ::\"r\"(4 + (cw + 1) % NWG) "
               ": \"memory\");\n"
               "      wgmma_wait<0>();\n\n      // The softmax of each row"),
              ("    const float scale_log2 = p.scale * LOG2E, neg_inf",
               "    if (cw == NWG - 1) asm volatile(\"bar.arrive %0, 256;\\n\" ::\"r\"(4) : "
               "\"memory\");\n    const float scale_log2 = p.scale * LOG2E, neg_inf")],
    "no_exp": [("s[i] = ex2(fmaf(s[i], scale_log2, neg[(i >> 1) & 1]));",
                "s[i] = fmaf(s[i], scale_log2, neg[(i >> 1) & 1]);")],
    # the products out (K2's S product has the same text): q through the ring to O
    "no_products": [("for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(s, dq + 2 * kk, dk + 2 * kk, "
                     "kk > 0);", "for (int kk = 0; kk < D / 16; ++kk) s[kk] = 0.f;"),
                    ("          wgmma_rs_tb(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], "
                     "pa[4 * kk + 3],\n                      dv + 128 * kk);",
                     "          o[kk] += __uint_as_float(pa[4 * kk]);")],
}
SHAPES = [(8, 4096, 77, 10), (8, 1024, 77, 20), (2, 4096, 77, 10), (2, 1024, 77, 20)]
ROUNDS = 2
SETS = 4


def run(use):
    import torch

    from fastedit_tpu_torch.ops import flash_attention as fa
    from fastedit_tpu_torch.tools.timing import PEAK_HBM_BYTES_PER_S, graph_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    real_q_tile = fa._q_tile
    for shape in SHAPES:
        b, sq, skv, h = shape
        # SETS copies of the inputs, called in turn, so that a call finds its q
        # in HBM and not in the 50 MB L2, as in an edit
        sets = [tuple(torch.randn((b, s, h, 64), generator=gen, device="cuda").bfloat16()
                      for s in (sq, skv, skv)) for _ in range(SETS)]
        q, k, v = sets[0]
        ref = fa.attention_plain(q, k, v).float()
        nbytes = 2.0 * b * h * 64 * (2 * sq + 2 * skv)
        turn = [0]

        def call():
            turn[0] += 1
            return fa.cross_attention(*sets[turn[0] % SETS])

        for _ in range(ROUNDS):
            for name in use.names:
                use(name)
                for bq in (128, 192):
                    fa._q_tile = lambda *a, bq=bq: bq
                    fa.plan_cross.cache_clear()
                    out = fa.cross_attention(q, k, v).float()
                    share = float((out != ref).float().mean())
                    ms = graph_ms(call)
                    hbm = 100 * nbytes / (1e-3 * ms) / PEAK_HBM_BYTES_PER_S
                    print(f"{str(shape):20s} {name:18s} bq {bq}  differing {share:.5f}  "
                          f"{1e3 * ms:.2f} us  {hbm:.1f}% of 3.35 TB/s", flush=True)
    fa._q_tile = real_q_tile
    fa.plan_cross.cache_clear()
