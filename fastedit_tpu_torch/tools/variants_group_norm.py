"""A spec for ``tools/kernel_variants.py``: the GroupNorm statistics kernel with
parts taken out, and with ``%globaltimer`` stamps at its phases, at three
main-path shapes (two small denoise shapes and the VAE's largest).

    python fastedit_tpu_torch/tools/kernel_variants.py \
        fastedit_tpu_torch/tools/variants_group_norm.py

The stamps variant records the nanoseconds from block (0, 0)'s start to: its
first stage landed (1), its stages done (2), its threads' statistics merged
(3); on two launches, the last block's turn (4), the chunks merged (5),
(scale, shift) written (6) and the apply launch's first block's start (7); on
the resident route, block (0, 0) past the barrier (4), the chunks merged (5)
and its output written (6).
"""

LIBRARY = "group_norm"

_STAMPS = [
    ("namespace {\n\nusing namespace hopper;",
     "namespace {\n\nusing namespace hopper;\n\n__device__ unsigned long long gn_stamps[8];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n  unsigned long long v;\n"
     "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(v));\n  return v;\n}\n"
     "__device__ __forceinline__ void stamp(bool on, int i) {\n"
     "  if (on) gn_stamps[i] = gtime();\n}"),
    ("  const char* xb = reinterpret_cast<const char*>(x + (long long)b * p.HW * C);\n",
     "  const char* xb = reinterpret_cast<const char*>(x + (long long)b * p.HW * C);\n"
     "  const bool first = t == 0 && chunk == 0 && b == 0;\n  stamp(first, 0);\n"),
    ("    mbar_wait(smem_u32(&full[s]), (i / p.stages) & 1);\n",
     "    mbar_wait(smem_u32(&full[s]), (i / p.stages) & 1);\n    stamp(first && i == 0, 1);\n"),
    ("      red_mean[t * 8 + e] = mean[e];", "      stamp(first && e == 0, 2);\n"
     "      red_mean[t * 8 + e] = mean[e];"),
    ("  __threadfence();\n  __syncthreads();\n  if constexpr (RESIDENT) {",
     "  stamp(first, 3);\n  __threadfence();\n  __syncthreads();\n  if constexpr (RESIDENT) {"),
    ("    merge_chunks(part, p, b, eps, red_mean, red_m2);\n    if (t == 0 && atomicAdd",
     "    stamp(first, 4);\n    merge_chunks(part, p, b, eps, red_mean, red_m2);\n"
     "    stamp(first, 5);\n    if (t == 0 && atomicAdd"),
    ("      for (int v = t; v < nvec; v += nt) ot[v] = affine8(tile[v], sc, sh, silu);\n    }\n"
     "    return;",
     "      for (int v = t; v < nvec; v += nt) ot[v] = affine8(tile[v], sc, sh, silu);\n    }\n"
     "    stamp(first, 6);\n    return;"),
    ("  if (!last) return;\n  __threadfence();\n",
     "  if (!last) return;\n  __threadfence();\n  stamp(t == 0 && b == 0, 4);\n"),
    ("  merge_chunks(part, p, b, eps, red_mean, red_m2);  // the last block\n",
     "  merge_chunks(part, p, b, eps, red_mean, red_m2);  // the last block\n"
     "  stamp(t == 0 && b == 0, 5);\n"),
    ("  if (t == 0) counter[b] = 0u;\n}", "  if (t == 0) counter[b] = 0u;\n"
     "  stamp(t == 0 && b == 0, 6);\n}"),
    ("  const int t = threadIdx.x, b = blockIdx.y;\n",
     "  const int t = threadIdx.x, b = blockIdx.y;\n"
     "  stamp(t == 0 && b == 0 && blockIdx.x == 0, 7);\n"),
    ("// The statistics launch alone:",
     "extern \"C\" int gn_read_stamps(void* host) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(host, gn_stamps, sizeof(gn_stamps)));\n}\n\n"
     "// The statistics launch alone:"),
]
_BLOCK_MERGE = ("        g < G ? p.lanes * cg : 0, sub, sl,", "        0, sub, sl,")
_LAST_MERGE = ("      g < G ? p.nchunk : 0, sub, sl,", "      0, sub, sl,")

VARIANTS = {
    "as_built": [],
    "stamps": _STAMPS,
    "no_block_merge": [_BLOCK_MERGE],
    "no_chunk_merge": [_LAST_MERGE],
    "no_merges": [_BLOCK_MERGE, _LAST_MERGE],
    "no_stage_math": [("    if (nb == 0) continue;", "    continue;")],
    "float_merges": [("double", "float")],
}
SHAPES = [(2, 32, 32, 640), (2, 128, 128, 320), (1, 1024, 1024, 128)]
ROUNDS = 2


def run(use):
    import ctypes

    import torch

    from fastedit_tpu_torch.ops import fused_groupnorm as fg
    from fastedit_tpu_torch.tools.timing import graph_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in SHAPES:
        x = (torch.randn(shape, generator=gen, device="cuda") + 0.5).bfloat16()
        gamma = torch.rand(shape[-1], generator=gen, device="cuda") + 0.5
        beta = torch.randn(shape[-1], generator=gen, device="cuda")
        use("as_built")
        ref = fg.group_norm_scale_shift(x, gamma, beta)
        print(shape, "plan", fg.plan_for(x, 32), flush=True)
        for _ in range(ROUNDS):
            for name in use.names:
                lib = use(name)
                scale, _ = fg.group_norm_scale_shift(x, gamma, beta)
                err = float((scale - ref[0]).abs().max())
                stats = graph_ms(lambda: fg.group_norm_scale_shift(x, gamma, beta))
                k7 = graph_ms(lambda: fg.fused_group_norm(x, gamma, beta, 32, 1e-5, "silu"))
                line = f"{name:15s} stats {1e3 * stats:8.2f} us  k7 {1e3 * k7:8.2f} us  err {err:.3g}"
                if name == "stamps":
                    for what, call, marks in (
                            ("statistics", lambda: fg.group_norm_scale_shift(x, gamma, beta),
                             range(1, 7)),
                            ("groupnorm", lambda: fg.fused_group_norm(x, gamma, beta, 32, 1e-5,
                                                                      "silu"), range(1, 8))):
                        call()
                        torch.cuda.synchronize()
                        buf = (ctypes.c_ulonglong * 8)()
                        lib.gn_read_stamps(ctypes.byref(buf))
                        line += f"\n   {what} stamps (us from block 0's start): " + " ".join(
                            f"{i}:{(buf[i] - buf[0]) / 1e3:.2f}" for i in marks)
                print(line, flush=True)
