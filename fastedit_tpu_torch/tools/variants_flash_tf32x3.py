"""A spec for ``tools/kernel_variants.py``: the fp32 attention kernels (3xTF32
on wgmma, D = 64 and D = 512) as built (the products of a group summed in a
fresh accumulator and added in with rounding to nearest), with every product
summed in the tensor cores' accumulators instead (``tensor_core_sums``: at D
= 512 S's k steps alternating over two chains, each group's stage handed back
once the next is issued; at D = 64 S in one accumulator and P V straight into
O), single-pass TF32 (the small products of S and of P V dropped; both
kernels), and at D = 512 with Q split on its way to the tensor cores instead
of once per call (``q_in_registers``: its panels land as they are and the
softmax warpgroup splits its A fragments in registers), with other ring
depths in the same shared memory, and, for its time alone, without the round
trip of P's fragments and rescale factors through the scratch
(``no_fragment_scratch``: pass 1 multiplies by zeros, so its output is
wrong), each held against an fp64 attention on the card beside the plain fp32
attention (TF32 off) and timed, at the VAE mid block's shape and the UNet's
two.  The D = 512 variants leave the D = 64 kernel as built, but
``q_in_registers``, whose prologue writes Q unsplit where the D = 64 kernel
reads Q's hi copy (and no lo copy): its D = 64 rows are wrong by design.

    python fastedit_tpu_torch/tools/kernel_variants.py \
        fastedit_tpu_torch/tools/variants_flash_tf32x3.py
"""

LIBRARY = "flash_attention_tf32x3"
# S = Q K^T: a panel's products, the small ones first, into the fresh accumulator s
_S_SMALL = ("            wgmma_tf32_ss(s, dql + 2 * kk, dkh + 2 * kk, kk > 0);\n"
            "            wgmma_tf32_ss(s, dqh + 2 * kk, dkl + 2 * kk);\n")
_S_HI = "          for (int kk = 0; kk < 4; ++kk) wgmma_tf32_ss(s, dqh + 2 * kk, dkh + 2 * kk);\n"
_S_GROUP = "#pragma unroll\n          for (int kk = 0; kk < 4; ++kk) {\n" + _S_SMALL + \
    "          }\n#pragma unroll\n" + _S_HI
_S_SUM = (
    "          wgmma_commit();\n"
    "          wgmma_wait<0>();\n"
    "          if (lane == 0) mbar_arrive(empty_qk(ks));\n"
    "          load_qk();\n"
    "#pragma unroll\n"
    "          for (int i = 0; i < BKV / 2; ++i) score[i] = pn > 0 ? score[i] + s[i] : s[i];\n"
    "          if (++ks == QK_STAGES) ks = 0, kp ^= 1;\n"
    "        }\n")
_S_DECL = "    float score[BKV / 2], s[BKV / 2];  // the scores, and a panel's products\n"
# P V: a V stage's products, the small ones first, into the fresh accumulator part
_PV_SMALL = ("                wgmma_tf32_rs(part, lo[kk], dvh + 2 * kk, kk > 0);\n"
             "                wgmma_tf32_rs(part, hi[kk], dvl + 2 * kk);\n")
_PV_GROUP = (
    "              // a fresh accumulator, the small products first\n"
    "#pragma unroll\n"
    "              for (int kk = 0; kk < 4; ++kk) {\n" + _PV_SMALL +
    "              }\n"
    "#pragma unroll\n"
    "              for (int kk = 0; kk < 4; ++kk) wgmma_tf32_rs(part, hi[kk], dvh + 2 * kk);\n"
    "              wgmma_commit();\n"
    "              wgmma_wait<0>();\n"
    "#pragma unroll\n"
    "              for (int i = 0; i < 32; ++i) o[c][i] += part[i];\n")

# D = 64: S's two panels into one accumulator, P V's two boxes straight into O
_D64_S_SUMS = [
    ("      s_panel(part, smem_desc(q_rows + Q_PANEL)",
     "      s_panel_on(score, smem_desc(q_rows + Q_PANEL)"),
    ("#pragma unroll\n      for (int i = 0; i < 32; ++i) score[i] += part[i];\n", ""),
    ("// d = P V of 32 keys (k steps k0 .. k0 + 3 of P's fragments) against a box of\n",
     "__device__ __forceinline__ void s_panel_on(float (&d)[32], uint64_t dqh, uint64_t dql,\n"
     "                                           uint64_t dkh, uint64_t dkl) {\n"
     "#pragma unroll\n"
     "  for (int kk = 0; kk < 4; ++kk) {\n"
     "    wgmma_tf32_ss(d, dql + 2 * kk, dkh + 2 * kk);\n"
     "    wgmma_tf32_ss(d, dqh + 2 * kk, dkl + 2 * kk);\n"
     "    wgmma_tf32_ss(d, dqh + 2 * kk, dkh + 2 * kk);\n"
     "  }\n"
     "}\n"
     "template <int K0>\n"
     "__device__ __forceinline__ void pv_box_on(float (&d)[32], const uint32_t (&hi)[8][4],\n"
     "                                          const uint32_t (&lo)[8][4], uint64_t dvh,\n"
     "                                          uint64_t dvl) {\n"
     "#pragma unroll\n"
     "  for (int kk = 0; kk < 4; ++kk) {\n"
     "    wgmma_tf32_rs(d, lo[K0 + kk], dvh + 2 * kk);\n"
     "    wgmma_tf32_rs(d, hi[K0 + kk], dvl + 2 * kk);\n"
     "    wgmma_tf32_rs(d, hi[K0 + kk], dvh + 2 * kk);\n"
     "  }\n"
     "}\n"
     "// d = P V of 32 keys (k steps k0 .. k0 + 3 of P's fragments) against a box of\n"),
    ("      pv_box<0>(part, phi, plo, smem_desc(vst), smem_desc(vst + HALF));\n"
     "      wgmma_commit();\n"
     "      wgmma_wait<0>();\n"
     "#pragma unroll\n"
     "      for (int i = 0; i < 32; ++i) o[i] += part[i];\n"
     "      wgmma_fence();\n"
     "      pv_box<4>(part, phi, plo, smem_desc(vst + TILE), smem_desc(vst + HALF + TILE));\n"
     "      wgmma_commit();\n"
     "      wgmma_wait<0>();\n"
     "#pragma unroll\n"
     "      for (int i = 0; i < 32; ++i) o[i] += part[i];\n",
     "      pv_box_on<0>(o, phi, plo, smem_desc(vst), smem_desc(vst + HALF));\n"
     "      pv_box_on<4>(o, phi, plo, smem_desc(vst + TILE), smem_desc(vst + HALF + TILE));\n"
     "      wgmma_commit();\n"
     "      wgmma_wait<0>();\n"),
]
_D64_ZERO = ("    if (kk == 0) {\n"
             "      for (int i = 0; i < 32; ++i) d[i] = 0.f;\n"
             "      wgmma_fence();\n"
             "    }\n")
_D64_SINGLE_PASS = [
    ("    wgmma_tf32_ss(d, dql + 2 * kk, dkh + 2 * kk, kk > 0);\n"
     "    wgmma_tf32_ss(d, dqh + 2 * kk, dkl + 2 * kk);\n", _D64_ZERO),
    ("    wgmma_tf32_rs(d, lo[K0 + kk], dvh + 2 * kk, kk > 0);\n"
     "    wgmma_tf32_rs(d, hi[K0 + kk], dvl + 2 * kk);\n", _D64_ZERO),
]

TENSOR_CORE_SUMS = _D64_S_SUMS + [
    (_S_DECL, "    float score[BKV / 2], s[2][BKV / 2];  // the scores, and two chains of S\n"
              "    int prev = 0;  // the stage of the panel before\n"),
    (_S_GROUP + _S_SUM,
     "#pragma unroll\n"
     "          for (int kk = 0; kk < 4; ++kk) {  // the small products first\n"
     "            wgmma_tf32_ss(s[kk % 2], dql + 2 * kk, dkh + 2 * kk, pn > 0 || kk >= 2);\n"
     "            wgmma_tf32_ss(s[kk % 2], dqh + 2 * kk, dkl + 2 * kk);\n"
     "            wgmma_tf32_ss(s[kk % 2], dqh + 2 * kk, dkh + 2 * kk);\n"
     "          }\n"
     "          wgmma_commit();\n"
     "          if (pn > 0) {  // the panel before has retired: its stage is free\n"
     "            wgmma_wait<1>();\n"
     "            if (lane == 0) mbar_arrive(empty_qk(prev));\n"
     "            load_qk();\n"
     "          }\n"
     "          prev = ks;\n"
     "          if (++ks == QK_STAGES) ks = 0, kp ^= 1;\n"
     "        }\n"
     "        wgmma_wait<0>();\n"
     "        if (lane == 0) mbar_arrive(empty_qk(prev));\n"
     "        load_qk();\n"
     "#pragma unroll\n"
     "        for (int i = 0; i < BKV / 2; ++i) score[i] = s[0][i] + s[1][i];\n"),
    (_PV_GROUP,
     "#pragma unroll\n"
     "              for (int kk = 0; kk < 4; ++kk) {\n"
     "                wgmma_tf32_rs(o[c], lo[kk], dvh + 2 * kk);\n"
     "                wgmma_tf32_rs(o[c], hi[kk], dvl + 2 * kk);\n"
     "                wgmma_tf32_rs(o[c], hi[kk], dvh + 2 * kk);\n"
     "              }\n"
     "              wgmma_commit();\n"
     "              wgmma_wait<0>();\n"),
]
SINGLE_PASS = _D64_SINGLE_PASS + [
    (_S_SMALL, "            if (kk == 0) {\n"
               "              for (int i = 0; i < BKV / 2; ++i) s[i] = 0.f;\n"
               "              wgmma_fence();\n"
               "            }\n"),
    (_PV_SMALL, "                if (kk == 0) {\n"
                "                  for (int i = 0; i < 32; ++i) part[i] = 0.f;\n"
                "                  wgmma_fence();\n"
                "                }\n"),
]
Q_IN_REGISTERS = [
    ("constexpr int K_OFFSET = 2 * TILE_BYTES;          // a stage: Q hi, Q lo, K hi, K lo\n",
     "constexpr int K_OFFSET = TILE_BYTES;              // a stage: Q, K hi, K lo\n"),
    ("      tma_load_3d_if(loader, stage + TILE_BYTES, &map_ql, bar, col, ld_q0, ld_bh);\n", ""),
    ("          // After the wait's loop, before the group (hopper.cuh: without its\n"
     "          // own fence here ptxas serialises every wgmma, C7520).\n"
     "          wgmma_fence();\n" + _S_GROUP,
     # a[e] of k step kk: row + 8 (e & 1), column 8 kk + quad + 4 (e >> 1) of the
     # panel, in 16-byte chunk 2 kk + (e >> 1) of its swizzled row
     "          uint32_t qhi[4][4], qlo[4][4];\n"
     "#pragma unroll\n"
     "          for (int kk = 0; kk < 4; ++kk)\n"
     "#pragma unroll\n"
     "            for (int e = 0; e < 4; ++e) {\n"
     "              const int r = row + 8 * (e & 1), chunk = 2 * kk + (e >> 1);\n"
     "              float v;\n"
     "              asm volatile(\"ld.shared.f32 %0, [%1];\\n\"\n"
     "                           : \"=f\"(v)\n"
     "                           : \"r\"(stage + r * 128 + ((chunk ^ (r & 7)) << 4) + quad * 4)\n"
     "                           : \"memory\");\n"
     "              split(v, qhi[kk][e], qlo[kk][e]);\n"
     "            }\n"
     "          wgmma_fence();\n"
     "#pragma unroll\n"
     "          for (int kk = 0; kk < 4; ++kk) {\n"
     "            wgmma_tf32_rs(s, qlo[kk], dkh + 2 * kk, kk > 0);\n"
     "            wgmma_tf32_rs(s, qhi[kk], dkl + 2 * kk);\n"
     "          }\n"
     "#pragma unroll\n"
     "          for (int kk = 0; kk < 4; ++kk) wgmma_tf32_rs(s, qhi[kk], dkh + 2 * kk);\n"),
    # the prologue writes Q as it is where its hi copy goes
    ("    if (which < 2) {\n",
     "    if (which == 0) {\n"
     "      a.hi[0][((long long)bh * S + s0 + i) * D + d0 + tx] = x;\n"
     "    } else if (which < 2) {\n"),
]
NO_FRAGMENT_SCRATCH = [
    ("            if (wg == 0 && quad == 0) alphas[j * BQ + row] = a0, "
     "alphas[j * BQ + row + 8] = a1;\n", ""),
    ("            a0 = __ldcg(alphas + j * BQ + row), a1 = __ldcg(alphas + j * BQ + row + 8);\n",
     "            a0 = a1 = 1.f;\n"),
    ("                if (wg == 0) __stcg(frag_at(j, ks), f);\n", ""),
    ("                f = __ldcg(frag_at(j, ks));\n",
     "                f = make_float4(0.f, 0.f, 0.f, 0.f);\n"),
]
VARIANTS = {
    "as_built": [],
    "tensor_core_sums": TENSOR_CORE_SUMS,
    "single_pass": SINGLE_PASS,
    "q_in_registers": Q_IN_REGISTERS,
    # the same shared memory in other ring depths: Q/K stages of 32 KB, V stages of 16 KB a
    # PV warpgroup (as built 3 and 3)
    "rings_2_4": [("constexpr int QK_STAGES = 3;", "constexpr int QK_STAGES = 2;"),
                  ("constexpr int V_STAGES = 3;", "constexpr int V_STAGES = 4;")],
    "rings_4_2": [("constexpr int QK_STAGES = 3;", "constexpr int QK_STAGES = 4;"),
                  ("constexpr int V_STAGES = 3;", "constexpr int V_STAGES = 2;")],
    "no_fragment_scratch": NO_FRAGMENT_SCRATCH,
}
# (B, Sq, Skv, H, D): the VAE mid block's head, the UNet's two 64-dim calls
SHAPES = [(1, 16384, 16384, 1, 512), (2, 4096, 4096, 10, 64), (2, 1024, 1024, 20, 64)]
ROUNDS = 2


def attention_fp64(q, k, v):
    """softmax(Q K^T / sqrt(D)) V in fp64 on the card, BSHD."""
    import torch

    qd, kd, vd = (t.double().transpose(1, 2) for t in (q, k, v))
    p = torch.softmax((qd @ kd.transpose(-1, -2)) * q.shape[-1] ** -0.5, dim=-1)
    return (p @ vd).transpose(1, 2)


def run(use):
    import torch

    from fastedit_tpu_torch.ops import flash_attention as fa
    from fastedit_tpu_torch.tools.timing import graph_ms
    from fastedit_tpu_torch.utils.precision import true_fp32

    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in SHAPES:
        b, sq, skv, h, d = shape
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                   for s in (sq, skv, skv))
        with true_fp32():
            ref = attention_fp64(q, k, v)
            plain = float((fa.attention_plain(q, k, v).double() - ref).abs().max())
            print(f"shape {shape}: plain fp32 max|err| vs fp64 {plain:.3e}, "
                  f"rms(ref) {float(ref.square().mean().sqrt()):.4f}", flush=True)
            flops = 4.0 * b * h * sq * skv * d
            for _ in range(ROUNDS):
                for name in use.names:
                    use(name)
                    out = fa.flash_attention(q, k, v)
                    err = float((out.double() - ref).abs().max())
                    ms = graph_ms(lambda: fa.flash_attention(q, k, v), reps=2, calls=3)
                    print(f"  {name:19s} max|err| {err:.3e} = {err / plain:7.2f} x plain  "
                          f"{ms:.3f} ms  {flops / ms / 1e9:.1f} TFLOP/s", flush=True)
        del ref
