"""A spec for ``tools/kernel_variants.py``: the GroupNorm kernel with parts
taken out, and with ``%globaltimer`` stamps at its phases, at bf16 and fp32
main-path shapes (small and middle denoise shapes and the VAE's largest); the
kernel as built is also timed on other schedules: cluster sizes 1, 2, 4 and 16
(``CLUSTER``), at most 32 or 64 resident blocks, only the largest stage, no
wide clusters for the calls bound by bytes.

    python fastedit_tpu_torch/tools/kernel_variants.py \
        fastedit_tpu_torch/tools/variants_group_norm.py

The stamps variant records the nanoseconds from block (0, 0)'s start to: its
first stage landed (1), its stages done (2), its threads' statistics merged
(3), its cluster's chunks merged and written (4); then for GroupNorm past the
batch item's barrier (5), the clusters merged (6) and its output stored (7:
on the reread route, its last bulk store has read its stage); for the
statistics alone, batch item 0's last cluster's turn (5) and (scale, shift)
written (6); and every block's start, the end of its own merge and its end
(min and max over the grid, µs from the first start).
"""

LIBRARY = "group_norm"

_STAMPS = [
    ("namespace {\n\nusing namespace hopper;",
     "namespace {\n\nusing namespace hopper;\n\n__device__ unsigned long long gn_stamps[8];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n  unsigned long long v;\n"
     "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(v));\n  return v;\n}\n"
     "__device__ __forceinline__ void stamp(bool on, int i) {\n"
     "  if (on) gn_stamps[i] = gtime();\n}\n"
     "__device__ unsigned long long gn_blocks[3][1024];  // start, merged, end per block\n"
     "__device__ __forceinline__ void mark(int i) {\n"
     "  if (threadIdx.x == 0) gn_blocks[i][(blockIdx.y * gridDim.x + blockIdx.x) & 1023] = gtime();\n}"),
    ("  const char* xb = reinterpret_cast<const char*>(x + (long long)b * p.HW * C);\n",
     "  const char* xb = reinterpret_cast<const char*>(x + (long long)b * p.HW * C);\n"
     "  const bool first = t == 0 && chunk == 0 && b == 0;\n  stamp(first, 0);\n  mark(0);\n"),
    ("    landed(s);\n    const Raw* tile = reinterpret_cast<const Raw*>(ring + s * stage_bytes);\n",
     "    landed(s);\n    stamp(first && i == 0, 1);\n"
     "    const Raw* tile = reinterpret_cast<const Raw*>(ring + s * stage_bytes);\n"),
    ("  if (t < nt) {\n#pragma unroll\n    for (int e = 0; e < 8; ++e) {\n      red_mean[t * 8 + e]",
     "  stamp(first, 2);\n  if (t < nt) {\n#pragma unroll\n    for (int e = 0; e < 8; ++e) {\n"
     "      red_mean[t * 8 + e]"),
    ("  if (p.cluster > 1) {\n    cluster_sync();",
     "  stamp(first, 3);\n  mark(1);\n  if (p.cluster > 1) {\n    cluster_sync();"),
    ("  cluster_arrive();  // block 0 is done with the others' cpart",
     "  stamp(first, 4);\n  cluster_arrive();  // block 0 is done with the others' cpart"),
    ("    __syncthreads();\n    merge_clusters(part, p, b, eps, red_mean, red_m2);  // the same",
     "    __syncthreads();\n    stamp(first, 5);\n"
     "    merge_clusters(part, p, b, eps, red_mean, red_m2);  // the same"),
    ("    if (t == 0 && atomicAdd(&counter[p.B + b], 1u) == (unsigned)(p.nchunk - 1)) {",
     "    stamp(first, 6);\n"
     "    if (t == 0 && atomicAdd(&counter[p.B + b], 1u) == (unsigned)(p.nchunk - 1)) {"),
    ("        __threadfence();\n        merge_clusters(part, p, b, eps, red_mean, red_m2);\n",
     "        __threadfence();\n        stamp(t == 0 && b == 0, 5);\n"
     "        merge_clusters(part, p, b, eps, red_mean, red_m2);\n"
     "        stamp(t == 0 && b == 0, 6);\n"),
    ("  cluster_wait();\n}\n\nint block_threads",
     "  stamp(first && APPLY, 7);\n  mark(2);\n  cluster_wait();\n}\n\nint block_threads"),
    ("// Blocks the card holds at once in clusters",
     "extern \"C\" int gn_read_stamps(void* host) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(host, gn_stamps, sizeof(gn_stamps)));\n}\n"
     "extern \"C\" int gn_read_blocks(void* host) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(host, gn_blocks, sizeof(gn_blocks)));\n}\n\n"
     "// Blocks the card holds at once in clusters"),
]


def _none(entries: str) -> tuple:  # a merge of no entries (its n is 0: NaN out)
    return (f"g < G ? {entries} : 0, sub, sl,", "0, sub, sl,")


VARIANTS = {
    "as_built": [],
    "stamps": _STAMPS,
    "no_block_merge": [_none("p.lanes * cg")],
    "no_cluster_merge": [_none("p.cluster")],
    "no_item_merge": [_none("ncl")],
    "no_stage_math": [("    if (nb == 0) continue;", "    continue;")],
    "float_merges": [("double", "float")],
    # the resident route through the bulk stores too, in place in the ring
    "bulk_resident": [("    if (!reread && sizeof(T) == 2) {", "    if (false) {")],
    # and the other way: fp32's resident route from registers too
    "register_resident": [("    if (!reread && sizeof(T) == 2) {", "    if (!reread) {")],
}
SHAPES = [  # (shape, dtype): bf16 and fp32 main-path shapes
    ((2, 32, 32, 640), "bfloat16"), ((2, 128, 128, 320), "bfloat16"),
    ((1, 1024, 1024, 128), "bfloat16"), ((2, 128, 128, 320), "float32"),
    ((1, 128, 128, 512), "float32"), ((2, 32, 32, 1280), "float32"),
    ((1, 1024, 1024, 128), "float32")]
ROUNDS = 2


def _spread(lib, plan) -> str:
    """Every block's start, the end of its own merge and its end: min/max
    over the grid in µs from the first start."""
    import ctypes

    blocks = (ctypes.c_ulonglong * (3 * 1024))()
    lib.gn_read_blocks(ctypes.byref(blocks))
    n = min(1024, plan.nchunk * plan.b)
    t0 = min(blocks[j] for j in range(n))
    return " ".join(f"{part} {(min(blocks[i * 1024 + j] for j in range(n)) - t0) / 1e3:.2f}/"
                    f"{(max(blocks[i * 1024 + j] for j in range(n)) - t0) / 1e3:.2f}"
                    for i, part in enumerate(("start", "merged", "end")))


def _plans(fg, real_slots):
    """Other schedules of the kernel as built, by the plan's knobs: the
    cluster size, fewer resident blocks, only the largest stage."""
    def slots(cap):
        return lambda x, cluster=8: min(cap, real_slots(x, cluster))

    knobs = {**{f"cluster {k:2d}": dict(CLUSTER=k) for k in (1, 2, 4, 16)},
             **{f"blocks <= {cap}": dict(slots_of=slots(cap)) for cap in (32, 64)},
             "largest stage": dict(VECS={2: (8,), 4: (4,)}),
             "no wide clusters": dict(WIDE_CLUSTER=8)}  # only the slots of CLUSTER
    # the plan uncached while its constants are patched
    return {name: dict(plan=fg.plan.__wrapped__, **patch) for name, patch in knobs.items()}


def run(use):
    import ctypes

    import torch

    from fastedit_tpu_torch.ops import fused_groupnorm as fg
    from fastedit_tpu_torch.tools.timing import graph_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    plans = _plans(fg, fg.slots_of)
    for shape, dtype in SHAPES:
        x = (torch.randn(shape, generator=gen, device="cuda") + 0.5).to(getattr(torch, dtype))
        gamma = torch.rand(shape[-1], generator=gen, device="cuda") + 0.5
        beta = torch.randn(shape[-1], generator=gen, device="cuda")
        use("as_built")
        ref = fg.group_norm_scale_shift(x, gamma, beta)
        print(shape, dtype, "plan", fg.plan_for(x, 32), flush=True)

        def stats():
            return fg.group_norm_scale_shift(x, gamma, beta)

        def k7():
            return fg.fused_group_norm(x, gamma, beta, 32, 1e-5, "silu")

        for _ in range(ROUNDS):
            for name in use.names:
                lib = use(name)
                err = float((stats()[0] - ref[0]).abs().max())
                line = (f"{name:16s} stats {1e3 * graph_ms(stats):8.2f} us  "
                        f"k7 {1e3 * graph_ms(k7):8.2f} us  err {err:.3g}")
                if name == "stamps":
                    for what, call, marks in (("statistics", stats, range(1, 7)),
                                              ("groupnorm", k7, range(1, 8))):
                        call()
                        torch.cuda.synchronize()
                        buf = (ctypes.c_ulonglong * 8)()
                        lib.gn_read_stamps(ctypes.byref(buf))
                        line += f"\n   {what} stamps (us from block 0's start): " + " ".join(
                            f"{i}:{(buf[i] - buf[0]) / 1e3:.2f}" for i in marks)
                        line += f"\n   {what} blocks: " + _spread(lib, fg.plan_for(x, 32))
                print(line, flush=True)
            use("as_built")
            for label, patch in plans.items():
                saved = {k: getattr(fg, k) for k in patch}
                for k, v in patch.items():
                    setattr(fg, k, v)
                try:
                    err = float((stats()[0] - ref[0]).abs().max())
                    pl = fg.plan_for(x, 32)
                    print(f"{label:16s} stats {1e3 * graph_ms(stats):8.2f} us  k7 "
                          f"{1e3 * graph_ms(k7):8.2f} us  err {err:.3g}  grid {pl.grid} "
                          f"cluster {pl.cluster} vecs {pl.vecs} {pl.route}", flush=True)
                finally:
                    for k, v in saved.items():
                        setattr(fg, k, v)
