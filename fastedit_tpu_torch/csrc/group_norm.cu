// GroupNorm (+ optional SiLU) over NHWC bf16 or fp32, fp32 statistics with a
// two-pass (centred) variance, in one launch; and the statistics alone, for
// the fused resnet conv's prologue.  Both kernels are one template over the
// element type T: a thread owns 8 channels of a pixel, one 16-byte vector in
// bf16 and two in fp32 (Vec8<T>), so the schedule's thread layout is the same
// for both and only the bytes of a stage double in fp32.
//
// Replaces the TPU kernel fastedit_tpu/ops/fused_groupnorm.py
// (`fused_group_norm` -> `_fused_gn_4d` / `_gn_kernel`), and serves the XLA
// function fastedit_tpu/ops/groupnorm.py `group_norm_scale_shift`.  The TPU
// kernel walks its grid in order and carries the group sums in VMEM scratch
// across three phases over the same tiles: sums, centred sum of squares (the
// one-pass E[x^2] - E[x]^2 cancels in fp32 when |mean| >> std), then
// normalise + affine (+ SiLU).  On the card, blocks run in parallel and in no
// order, so one launch does it all with every block resident at once:
//
//   statistics   grid (chunk, batch item), at most one block per SM, every
//                block of the grid on the card at once (ops/fused_groupnorm.plan
//                sizes the grid to what cudaOccupancyMaxActiveClusters reports;
//                GroupNorm is a cooperative launch, which the driver refuses
//                otherwise).  A block streams its chunk of whole
//                pixels (all C channels) through a ring of shared-memory stages,
//                one 1-D bulk copy (TMA) per stage.  Each thread takes its
//                values of a stage into registers, computes their mean and then
//                their centred M2 per channel (two passes over the copy on
//                chip), and merges them into its running (n, mean, M2) (Chan's
//                merge); at the chunk's end the block merges its threads'
//                statistics per group, in a fixed order, into its chunk's
//                (mean, M2).
//   cluster      the blocks of a batch item come in thread-block clusters of
//                `cluster` (up to 8: portable), neighbouring chunks.  After a
//                cluster barrier block 0 reads its cluster's chunk statistics
//                out of the blocks' shared memory (distributed shared memory:
//                mapa / ld.shared::cluster), merges them in rank order and
//                writes the result, one partial per cluster, to device memory.
//                A plan of clusters of one launches without clusters (the card
//                schedules that faster) and each block writes its own.
//   batch item   GroupNorm: block 0 of each cluster arrives at a counter of
//                its batch item, and every block waits for the item's clusters
//                (a spin that traps after SPIN_LIMIT_NS rather than hang) and
//                merges their partials in a fixed order, the same bits in
//                every block.  The statistics alone: the last cluster of the
//                item to arrive merges them and writes scale = rstd * gamma,
//                shift = beta - mean * scale per channel.  The last block to
//                leave sets the counters back to 0, so the kernel is right
//                under a CUDA graph's replays.
//   apply        y = x * scale + shift (+ SiLU with __fdividef), one rounding to
//                T (none in fp32).  Where the ring holds the chunk whole (the
//                plan's "resident" route: x read once), each thread's vectors
//                are stored from registers; otherwise (the "reread" route) tile
//                by tile in the reverse order of loading, normalised in place
//                and written by bulk stores (cp.async.bulk): first the `stages`
//                tiles still in the ring, then the tiles no ring kept, which
//                the item's blocks take from one counter (the blocks that the
//                memory system served late take fewer), the latest loaded
//                first, the likeliest to be in L2, each into a stage whose
//                store has read it.  fp32 chunks held whole go through the
//                bulk stores too (faster there; bf16's faster from registers).
//
// Every sum is taken in a fixed order (no float atomics), so two launches give
// the same bits.  What bounds it on an H100: bytes.  At ~5 FLOPs per element
// it lies far below the card's ridge point; the least time is one read of x
// and one write of the output at HBM bandwidth.
//
// Thread layout: with VC = C / 8 vectors of 8 channels per pixel, a block has
// lanes * VC data threads (lanes = 512 / VC, at least one); thread t owns
// channel vector t % VC of every lanes-th pixel, from pixel t / VC on.  In a
// stage of whole pixels that is vector t, t + NT, t + 2 NT, ... (NT = lanes *
// VC): neighbouring threads read neighbouring 16 (bf16) or 32 (fp32) bytes.  No
// block-wide step per stage but the barrier before a stage is refilled: a
// thread's statistics stay in its registers until the chunk ends.  Then they go
// to shared memory, [lanes][C], and each group's lanes * C / G entries are
// merged by a run of lanes of one warp, all groups at once (group_merge:
// lane-strided sums, then a butterfly of shuffles, in double); the cluster's
// and the batch item's merges take the same form over their partials.  The
// schedule (lanes, stage size, ring depth, chunks, cluster) comes from
// ops/fused_groupnorm.plan.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int MAX_THREADS = 512;
constexpr int MAX_C = 4096;         // 512 vectors; [lanes][C] partials fill MAX_C floats
constexpr int MAX_G = 128;
constexpr int MAX_STAGES = 8;
constexpr int RING_BYTES = 192 * 1024;  // the stages of one block
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_PARTIALS = 128;   // clusters per batch item
// A batch item's barrier gives up (traps) after this long: a grid that is not
// all resident would otherwise spin for ever.
constexpr unsigned long long SPIN_LIMIT_NS = 1000000000ull;

struct Plan {  // ops/fused_groupnorm.plan, as the wrapper passes it
  int B, HW, C, G;
  int lanes;    // pixels a block covers side by side
  int tile_px;  // pixels per stage
  int ntiles;   // stages per batch item
  int nchunk;   // blocks per batch item: chunk k holds tiles [k ntiles / nchunk, (k + 1) ...)
  int stages;   // ring depth
  int cluster;  // blocks per cluster; nchunk is a multiple of it
};

__host__ __device__ __forceinline__ int chunk_tile(const Plan& p, int k) {
  return (int)((long long)k * p.ntiles / p.nchunk);
}
// Pixels of chunks [k0, k1) of a batch item.
__device__ __forceinline__ int span_px(const Plan& p, int k0, int k1) {
  return min(p.HW, chunk_tile(p, k1) * p.tile_px) - chunk_tile(p, k0) * p.tile_px;
}

// Eight channels of one pixel: one 16-byte vector of bf16, two of fp32.
template <typename T>
struct Vec8;
template <>
struct Vec8<__nv_bfloat16> {
  using Raw = uint4;
  static constexpr int MAX_VECS = 8;
};
struct __align__(16) Float8 {
  float4 lo, hi;
};
template <>
struct Vec8<float> {
  using Raw = Float8;
  static constexpr int MAX_VECS = 4;  // the same 128 bytes per thread and stage
};

__device__ __forceinline__ void unpack8(const uint4& raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 v = __bfloat1622float2(h[e]);
    f[2 * e] = v.x;
    f[2 * e + 1] = v.y;
  }
}
__device__ __forceinline__ void unpack8(const Float8& raw, float* f) {
  f[0] = raw.lo.x, f[1] = raw.lo.y, f[2] = raw.lo.z, f[3] = raw.lo.w;
  f[4] = raw.hi.x, f[5] = raw.hi.y, f[6] = raw.hi.z, f[7] = raw.hi.w;
}

// Thread-block clusters: the block's rank, the cluster barrier in two halves,
// and loads from another block's shared memory.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
// The address of `p` (in this block's shared memory) in block `rank`'s.
__device__ __forceinline__ uint32_t in_block(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ float2 ld_cluster_f2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(a)
               : "memory");
  return v;
}
// A 1-D bulk copy of `bytes` from shared to global memory, in its own bulk
// group of the issuing thread; bulk_wait_read<N> waits until all but the
// newest N of its groups have read their source.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long v;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(v));
  return v;
}

// Lanes that merge one group's entries: the fewest of 32, 16, ..., 1 with
// which the block's warps take all G groups in one round.
__device__ __forceinline__ int merge_lanes(int G) {
  const int warps = blockDim.x >> 5;
  int sub = 32;
  while (sub > 1 && warps * (32 / sub) < G) sub >>= 1;
  return sub;
}

// Sum over each aligned run of `sub` lanes in a fixed order: a butterfly of
// shuffles, after which the run's lanes hold the same bits (each step adds
// the same two values).
__device__ __forceinline__ double sub_sum(double v, int sub) {
  for (int off = sub >> 1; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The statistics (n_k, mean_k, M2_k) of `m` entries merged into one by `sub`
// lanes (lane i of them is `lane`), in double and in a fixed order: the mean
// from the weighted sum of the means, then M2 = sum of M2_k + n_k (mean_k -
// mean)^2, the partials' own two-pass form (entries centred on the merged
// mean, so |mean| >> std does not cancel).  Each sum: lane i adds entries i,
// i + sub, ... in turn (`entry(k, n, mean, m2)` reads entry k), then sub_sum.
// Every lane of the run gets the result; all 32 lanes of the warp must call.
template <typename Entry>
__device__ __forceinline__ void group_merge(int m, int sub, int lane, Entry entry, double& n,
                                            double& mean, double& m2) {
  double sn = 0.0, s1 = 0.0, s2 = 0.0;
#pragma unroll 4
  for (int k = lane; k < m; k += sub) {
    double nk, mk, qk;
    entry(k, nk, mk, qk);
    sn += nk;
    s1 += nk * mk;
  }
  n = sub_sum(sn, sub);
  mean = sub_sum(s1, sub) / n;
#pragma unroll 4
  for (int k = lane; k < m; k += sub) {
    double nk, mk, qk;
    entry(k, nk, mk, qk);
    const double d = mk - mean;
    s2 += qk + nk * d * d;
  }
  m2 = sub_sum(s2, sub);
}

// The clusters' statistics of batch item b, part[b, :, :], merged per group by
// the whole block: staged in shared memory in one sweep (clusters x G <=
// MAX_C), then group_merge.  Leaves the group's mean in mean_out[g] and its
// rstd in rstd_out[g] (the staging arrays themselves).
__device__ void merge_clusters(const float2* part, const Plan& p, int b, float eps,
                               float* mean_out, float* rstd_out) {
  __shared__ int cluster_px[MAX_PARTIALS];  // each cluster's pixels
  const int t = threadIdx.x, G = p.G, cg = p.C / G, ncl = p.nchunk / p.cluster;
  for (int i = t; i < ncl * G; i += blockDim.x) {
    const float2 pk = __ldcg(&part[(long long)b * ncl * G + i]);
    mean_out[i] = pk.x;
    rstd_out[i] = pk.y;
  }
  for (int k = t; k < ncl; k += blockDim.x)
    cluster_px[k] = span_px(p, k * p.cluster, (k + 1) * p.cluster);
  __syncthreads();
  const int sub = merge_lanes(G), sl = t & (sub - 1);
  const int g = (t >> 5) * (32 / sub) + (t & 31) / sub;
  double n, mu, q;
  group_merge(
      g < G ? ncl : 0, sub, sl,
      [&](int k, double& nk, double& mk, double& qk) {
        nk = (double)cluster_px[k] * cg, mk = mean_out[k * G + g], qk = rstd_out[k * G + g];
      },
      n, mu, q);
  __syncthreads();  // the staged partials are read: their space takes the results
  if (g < G && sl == 0) {
    mean_out[g] = (float)mu;
    rstd_out[g] = (float)(1.0 / sqrt(q / n + (double)eps));
  }
  __syncthreads();
}

// mbar_wait that traps after SPIN_LIMIT_NS: a stage whose copy was never
// asked for fails the launch instead of hanging the card.
__device__ __forceinline__ void wait_landed(uint32_t bar, int parity) {
  const unsigned long long t0 = global_ns();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && global_ns() - t0 > SPIN_LIMIT_NS) __trap();
  } while (!done);
}

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint4 affine8(const uint4& raw, const float* sc, const float* sh,
                                         int silu) {
  float f[8];
  unpack8(raw, f);
  uint4 out;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float y0 = f[2 * e] * sc[2 * e] + sh[2 * e];
    float y1 = f[2 * e + 1] * sc[2 * e + 1] + sh[2 * e + 1];
    if (silu) {
      y0 = __fdividef(y0, 1.f + __expf(-y0));  // no IEEE division slow path
      y1 = __fdividef(y1, 1.f + __expf(-y1));
    }
    h[e] = __floats2bfloat162_rn(y0, y1);
  }
  return out;
}
__device__ __forceinline__ Float8 affine8(const Float8& raw, const float* sc, const float* sh,
                                          int silu) {
  float f[8];
  unpack8(raw, f);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    f[e] = f[e] * sc[e] + sh[e];
    if (silu) f[e] = __fdividef(f[e], 1.f + __expf(-f[e]));
  }
  return Float8{make_float4(f[0], f[1], f[2], f[3]), make_float4(f[4], f[5], f[6], f[7])};
}

// Grid (nchunk, B) in clusters of (cluster, 1), lanes * VC threads rounded up
// to warps.  Each thread keeps (n, mean, M2) of its eight channels over its
// pixels of the chunk: per stage the mean and centred M2 of its (up to `vecs`)
// values, from registers, merged into the running ones.  Then the block merges
// them per group (entries lane-row major) into cpart[g] = (mean, M2), the
// cluster's are merged (block 0 writes part[b, cluster, g]), and the batch
// item's clusters are merged as the file's head says.
//
// APPLY (GroupNorm): every block of the grid resident at once; each cluster's
// block 0 arrives at counter[b], every block waits for the item's clusters,
// merges them and normalises its chunk into out.  The last block to leave
// sets counter[b] and counter[B + b] back to 0.  Otherwise (the statistics
// alone): the last block 0 of batch item b to arrive merges the clusters and
// writes scale_shift[0, b, :] and scale_shift[1, b, :], and sets counter[b]
// to 0.
template <typename T, bool APPLY>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    gn_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, float* __restrict__ scale_shift, float2* part,
              unsigned int* counter, const Plan p, float eps, T* __restrict__ out, int silu) {
  using Raw = typename Vec8<T>::Raw;
  constexpr int VECS = Vec8<T>::MAX_VECS;
  extern __shared__ __align__(128) uint8_t ring[];
  // [lanes][C] statistics; then the clusters' partials, then [G] (mean, rstd)
  __shared__ float red_mean[MAX_C], red_m2[MAX_C];
  __shared__ float2 cpart[MAX_G];  // the chunk's (mean, M2) per group
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  __shared__ int job_tile[MAX_STAGES];  // the apply's jobs: the item's tile in each stage
  __shared__ int last;

  const int t = threadIdx.x, b = blockIdx.y, chunk = blockIdx.x, rank = cluster_rank();
  const int ncl = p.nchunk / p.cluster, cl = chunk / p.cluster;
  const int C = p.C, G = p.G, cg = C / G, vc = C / 8, nt = p.lanes * vc, S = p.stages;
  const int vecs = p.tile_px / p.lanes, tile0 = chunk_tile(p, chunk);
  const int ntile = chunk_tile(p, chunk + 1) - tile0;
  const int stage_bytes = p.tile_px * C * (int)sizeof(T);
  const char* xb = reinterpret_cast<const char*>(x + (long long)b * p.HW * C);

  // this thread's channels' gamma and beta, read while the first stages land
  const int c0 = (t % vc) * 8;
  float gm[8] = {}, bt[8] = {};
  if constexpr (APPLY) {
#pragma unroll
    for (int e = 0; e < 8; ++e) gm[e] = gamma[c0 + e], bt[e] = beta[c0 + e];
  }

  auto pixels = [&](int i) { return min(p.tile_px, p.HW - (tile0 + i) * p.tile_px); };
  auto issue = [&](int i) {  // thread 0: tile i of the chunk into stage i % stages
    const int s = i % S, bytes = pixels(i) * C * (int)sizeof(T);
    mbar_expect_tx(smem_u32(&full[s]), bytes);
    bulk_load(smem_u32(ring + s * stage_bytes), xb + (long long)(tile0 + i) * stage_bytes, bytes,
              smem_u32(&full[s]));
  };
  uint32_t phase = 0;  // bit s: the parity of stage s's next load
  auto landed = [&](int s) {
    wait_landed(smem_u32(&full[s]), (phase >> s) & 1);
    phase ^= 1u << s;
  };
  if (t == 0) {
    for (int s = 0; s < S; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < min(S, ntile); ++i) issue(i);
  }
  __syncthreads();

  float cnt = 0.f, mean[8], m2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) mean[e] = m2[e] = 0.f;
  for (int i = 0; i < ntile; ++i) {
    const int s = i % S, nvec = pixels(i) * vc;
    landed(s);
    const Raw* tile = reinterpret_cast<const Raw*>(ring + s * stage_bytes);
    Raw raw[VECS];
    int nb = 0;  // this thread's values per channel in the stage: vectors 0 .. nb - 1
#pragma unroll
    for (int k = 0; k < VECS; ++k) {
      const int v = t + k * nt;
      if (t < nt && k < vecs && v < nvec) {
        raw[k] = tile[v];
        nb = k + 1;
      }
    }
    if (i + S < ntile) {  // every thread holds its part of the stage: refill it
      __syncthreads();
      if (t == 0) issue(i + S);
    }
    if (nb == 0) continue;
    float lm[8], lq[8], f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) lm[e] = lq[e] = 0.f;
#pragma unroll
    for (int k = 0; k < VECS; ++k) {
      if (k < nb) {
        unpack8(raw[k], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) lm[e] += f[e];
      }
    }
    const float inv_nb = 1.f / (float)nb;
#pragma unroll
    for (int e = 0; e < 8; ++e) lm[e] *= inv_nb;
#pragma unroll
    for (int k = 0; k < VECS; ++k) {
      if (k < nb) {
        unpack8(raw[k], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = f[e] - lm[e];
          lq[e] += d * d;
        }
      }
    }
    // Chan's merge into the running statistics, its weights shared by the
    // eight channels
    const float tot = cnt + (float)nb, inv_tot = 1.f / tot;
    const float wb = (float)nb * inv_tot, wab = cnt * (float)nb * inv_tot;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float delta = lm[e] - mean[e];
      mean[e] += delta * wb;
      m2[e] += lq[e] + delta * delta * wab;
    }
    cnt = tot;
  }
  if (t < nt) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      red_mean[t * 8 + e] = mean[e];
      red_m2[t * 8 + e] = m2[e];
    }
  }
  __syncthreads();

  // Group g: lanes [sub * (g % per_warp), + sub) of warp g / per_warp.
  const int sub = merge_lanes(G), per_warp = 32 / sub, sl = t & (sub - 1);
  const int g = (t >> 5) * per_warp + (t & 31) / sub;
  {
    // pixels lane row l saw: `vecs` a stage but in the chunk's last, where
    // the image may end: q, and one more in rows l < r
    const int end_px = pixels(ntile - 1), q_last = end_px / p.lanes, r_last = end_px % p.lanes;
    const int seen = (ntile - 1) * vecs + q_last;
    double n, mu, q;
    group_merge(
        g < G ? p.lanes * cg : 0, sub, sl,
        [&](int k, double& nk, double& mk, double& qk) {
          const int l = k / cg, c = l * C + g * cg + (k - l * cg);
          nk = (float)(seen + (l < r_last)), mk = red_mean[c], qk = red_m2[c];
        },
        n, mu, q);
    if (g < G && sl == 0) {
      cpart[g] = make_float2(mu, q);
      // a cluster of one block: its chunk's partial is the cluster's
      if (p.cluster == 1) part[((long long)b * ncl + cl) * G + g] = make_float2(mu, q);
    }
  }
  if (p.cluster > 1) {
    cluster_sync();  // every chunk's statistics are in its block's cpart
    if (rank == 0) {  // the cluster's chunks, merged in rank order: one partial per cluster
      double n, mu, q;
      group_merge(
          g < G ? p.cluster : 0, sub, sl,
          [&](int r, double& nk, double& mk, double& qk) {
            const float2 v = ld_cluster_f2(in_block(&cpart[g], r));
            nk = (double)span_px(p, chunk + r, chunk + r + 1) * cg, mk = v.x, qk = v.y;
          },
          n, mu, q);
      if (g < G && sl == 0) part[((long long)b * ncl + cl) * G + g] = make_float2(mu, q);
    }
  }
  if (rank == 0) {
    __threadfence();
    __syncthreads();
  }
  cluster_arrive();  // block 0 is done with the others' cpart (each waits before it leaves)
  if constexpr (!APPLY) {
    if (rank == 0) {
      if (t == 0) last = atomicAdd(&counter[b], 1u) == (unsigned)(ncl - 1);
      __syncthreads();
      if (last) {  // the last cluster of batch item b
        __threadfence();
        merge_clusters(part, p, b, eps, red_mean, red_m2);
        float* scale = scale_shift + (long long)b * C;
        float* shift = scale_shift + ((long long)p.B + b) * C;
        for (int c = t; c < C; c += blockDim.x) {
          const float sc = red_m2[c / cg] * gamma[c];
          scale[c] = sc;
          shift[c] = beta[c] - red_mean[c / cg] * sc;
        }
        if (t == 0) counter[b] = 0u;
      }
    }
  } else {
    // the batch item's barrier: each cluster's block 0 arrives, every block waits
    if (t == 0) {
      if (rank == 0) atomicAdd(&counter[b], 1u);
      const unsigned long long t0 = global_ns();
      while (load_acquire(&counter[b]) < (unsigned)ncl) {
        __nanosleep(32);
        if (global_ns() - t0 > SPIN_LIMIT_NS) __trap();
      }
    }
    __syncthreads();
    merge_clusters(part, p, b, eps, red_mean, red_m2);  // the same order in every block
    if (t == 0 && atomicAdd(&counter[p.B + b], 1u) == (unsigned)(p.nchunk - 1)) {
      counter[b] = 0u;  // every block of b has passed the barrier
      counter[p.B + b] = 0u;
    }
    float sc[8], sh[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int ge = (c0 + e) / cg;
      sc[e] = red_m2[ge] * gm[e];
      sh[e] = bt[e] - red_mean[ge] * sc[e];
    }
    char* ob = reinterpret_cast<char*>(out + (long long)b * p.HW * C);
    // reread: some chunk of the item does not fit its ring (the same for every block)
    const bool reread = (long long)p.nchunk * S < p.ntiles;
    if (!reread && sizeof(T) == 2) {
      // The chunk is on chip: each thread's vectors of every tile, normalised
      // and stored from registers, no block-wide step.
      Raw* o = reinterpret_cast<Raw*>(ob) + (long long)tile0 * p.tile_px * vc;
      for (int i = 0; i < ntile; ++i) {
        const Raw* tile = reinterpret_cast<const Raw*>(ring + i * stage_bytes);
        const int nvec = pixels(i) * vc;
#pragma unroll
        for (int k = 0; k < VECS; ++k) {
          const int v = t + k * nt;
          if (t < nt && k < vecs && v < nvec) o[v] = affine8(tile[v], sc, sh, silu);
        }
        o += p.tile_px * vc;
      }
    } else {
      // Jobs, each a tile normalised in place in its stage and written by a
      // bulk store: first the chunk's tiles in the ring, the last loaded
      // first; then, on the reread route, the tiles that no ring kept, taken
      // by every block of the item from one counter (job j + stages takes the
      // stage of job j, refilled once its store has read it), in rounds over
      // the chunks from each one's latest such tile back, the likeliest to be
      // in L2.  job_tile[s]: the item's tile in stage s, -1 past the last.
      const int rounds = (p.ntiles + p.nchunk - 1) / p.nchunk - S;
      unsigned int* work = counter + 2 * p.B + b;
      auto grab = [&]() {  // thread 0: the next tile no ring kept, or -1
        for (;;) {
          const int w = (int)atomicAdd(work, 1u);
          if (!reread || w >= p.nchunk * rounds) return -1;
          const int r = w / p.nchunk, c = w - r * p.nchunk;
          const int tile = chunk_tile(p, c + 1) - S - 1 - r;
          if (tile >= chunk_tile(p, c)) return tile;
        }
      };
      auto slot = [&](int j) { return ((ntile - 1 - j % S) % S + S) % S; };
      if (t < S) job_tile[t] = -1;
      __syncthreads();
      if (t < min(S, ntile)) job_tile[slot(t)] = tile0 + ntile - 1 - t;
      __syncthreads();
      for (int j = 0; reread || j < ntile; ++j) {
        const int s = slot(j), tile_no = job_tile[s];
        if (tile_no < 0) break;
        if (j >= S) landed(s);
        const int px = min(p.tile_px, p.HW - tile_no * p.tile_px), nvec = px * vc;
        Raw* tile = reinterpret_cast<Raw*>(ring + s * stage_bytes);
#pragma unroll
        for (int k = 0; k < VECS; ++k) {
          const int v = t + k * nt;
          if (t < nt && k < vecs && v < nvec) tile[v] = affine8(tile[v], sc, sh, silu);
        }
        fence_async_shared();
        __syncthreads();
        if (t == 0) {
          bulk_store(ob + (long long)tile_no * stage_bytes, smem_u32(tile),
                     px * C * (int)sizeof(T));
          if (reread && j >= 1) {  // the stage of job j - 1 takes job j - 1 + stages
            const int sp = slot(j - 1), next = grab();
            job_tile[sp] = next;
            if (next >= 0) {
              bulk_wait_read<1>();
              const int bytes = min(p.tile_px, p.HW - next * p.tile_px) * C * (int)sizeof(T);
              mbar_expect_tx(smem_u32(&full[sp]), bytes);
              bulk_load(smem_u32(ring + sp * stage_bytes), xb + (long long)next * stage_bytes,
                        bytes, smem_u32(&full[sp]));
            }
          }
        }
      }
      if (t == 0) {
        bulk_wait_read<0>();
        // the item's last block to finish sets its work counter back to 0
        if (reread && atomicAdd(counter + 3 * p.B + b, 1u) == (unsigned)(p.nchunk - 1)) {
          *work = 0u;
          counter[3 * p.B + b] = 0u;
        }
      }
    }
  }
  cluster_wait();
}

int block_threads(const Plan& p) { return (p.lanes * (p.C / 8) + 31) / 32 * 32; }

// The plan's numbers, checked against what the kernel takes; 0 or a CUDA error.
template <typename T>
int check(const Plan& p) {
  const bool ok =
      p.B >= 1 && p.HW >= 1 && p.C % 8 == 0 && p.C <= MAX_C && p.G >= 1 && p.G <= MAX_G &&
      p.C % p.G == 0 && p.lanes >= 1 && p.lanes * (p.C / 8) <= MAX_THREADS &&
      block_threads(p) >= p.G && p.tile_px >= 1 && p.tile_px % p.lanes == 0 &&
      p.tile_px / p.lanes <= Vec8<T>::MAX_VECS && p.stages >= 1 && p.stages <= MAX_STAGES &&
      (long long)p.stages * p.tile_px * p.C * (int)sizeof(T) <= RING_BYTES &&
      p.ntiles == (p.HW + p.tile_px - 1) / p.tile_px && p.cluster >= 1 &&
      p.cluster <= MAX_CLUSTER && p.nchunk >= p.cluster && p.nchunk % p.cluster == 0 &&
      p.nchunk <= p.ntiles && (p.nchunk / p.cluster) * p.G <= MAX_C &&
      p.nchunk / p.cluster <= MAX_PARTIALS && p.B <= 65535 &&
      // a chunk past its ring: three stages at least (the apply's jobs)
      ((long long)p.nchunk * p.stages >= p.ntiles || p.stages >= 3);
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Each instance's dynamic shared memory limit and cluster sizes past 8, set
// once per device.
template <typename T, bool APPLY>
int configure() {
  static unsigned long long configured = 0;  // one bit per device
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!(configured >> (device & 63) & 1)) {
    e = cudaFuncSetAttribute(gn_kernel<T, APPLY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             RING_BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(gn_kernel<T, APPLY>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured |= 1ull << (device & 63);
  }
  return 0;
}

// Grid (nchunk, B) in clusters of (cluster, 1) (a launch without clusters
// where cluster is 1 and `launch`: the card schedules it faster); cooperative:
// the driver launches it only if every block is resident at once.
cudaLaunchConfig_t config(const Plan& p, int threads, size_t smem, cudaStream_t s,
                          bool cooperative, bool launch, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.nchunk, p.B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  if (p.cluster > 1 || !launch) {
    attr[cfg.numAttrs].id = cudaLaunchAttributeClusterDimension;
    attr[cfg.numAttrs].val.clusterDim.x = p.cluster;
    attr[cfg.numAttrs].val.clusterDim.y = 1;
    attr[cfg.numAttrs++].val.clusterDim.z = 1;
  }
  if (cooperative) {
    attr[cfg.numAttrs].id = cudaLaunchAttributeCooperative;
    attr[cfg.numAttrs++].val.cooperative = 1;
  }
  return cfg;
}

// Blocks of gn_kernel<T, APPLY> the card holds at once in clusters of
// `cluster` (cudaOccupancyMaxActiveClusters x cluster, at the largest shared
// memory and block), cached per device; 0 where the query fails.
template <typename T, bool APPLY>
int slots(int cluster) {
  static int cache[64][MAX_CLUSTER + 1] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || configure<T, APPLY>() || cluster < 1 ||
      cluster > MAX_CLUSTER)
    return 0;
  int& n = cache[device & 63][cluster];
  if (n == 0) {
    Plan p{};
    p.nchunk = cluster;
    p.B = 1;
    p.cluster = cluster;
    cudaLaunchAttribute attr[2];
    const cudaLaunchConfig_t cfg = config(p, MAX_THREADS, RING_BYTES, nullptr, false, false, attr);
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, gn_kernel<T, APPLY>, &cfg) != cudaSuccess) {
      cudaGetLastError();
      return 0;
    }
    n = clusters * cluster;
  }
  return n;
}

template <typename T, bool APPLY>
int launch(const void* x, const void* gamma, const void* beta, void* scale_shift, void* out,
           void* part, void* counter, const Plan& p, float eps, int silu, void* stream) {
  if (int err = check<T>(p)) return err;
  if (int err = configure<T, APPLY>()) return err;
  // GroupNorm's batch items meet at a barrier: a cooperative launch, every
  // block resident at once (or refused: cudaErrorCooperativeLaunchTooLarge)
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg =
      config(p, block_threads(p), (size_t)p.stages * p.tile_px * p.C * sizeof(T),
             static_cast<cudaStream_t>(stream), APPLY, true, attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, gn_kernel<T, APPLY>, static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(scale_shift),
      static_cast<float2*>(part), static_cast<unsigned int*>(counter), p, eps,
      static_cast<T*>(out), silu);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// Blocks the card holds at once in clusters of `cluster`, for every instance
// of the kernel (the least of them), into *out: what ops/fused_groupnorm.plan
// sizes the grid to.
extern "C" int group_norm_slots(int cluster, int* out) {
  const int n[4] = {slots<__nv_bfloat16, true>(cluster), slots<__nv_bfloat16, false>(cluster),
                    slots<float, true>(cluster), slots<float, false>(cluster)};
  int least = n[0];
  for (int v : n) least = min(least, v);
  *out = least;
  return least > 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The statistics alone: scale_shift [2, B, C] fp32 (scale, then shift).  x [B,
// HW, C] bf16, 16-byte aligned; gamma, beta [C] fp32; part [B, nchunk /
// cluster, G] float2 of workspace; counter [B] uint32, zero before the call and
// zero after it.
extern "C" int group_norm_stats_bf16(const void* x, const void* gamma, const void* beta,
                                     void* scale_shift, void* part, void* counter, int B, int HW,
                                     int C, int G, int lanes, int tile_px, int ntiles,
                                     int nchunk, int stages, int cluster, float eps,
                                     void* stream) {
  const Plan p{B, HW, C, G, lanes, tile_px, ntiles, nchunk, stages, cluster};
  return launch<__nv_bfloat16, false>(x, gamma, beta, scale_shift, nullptr, part, counter, p, eps,
                                      0, stream);
}
// The same for x in fp32.
extern "C" int group_norm_stats_f32(const void* x, const void* gamma, const void* beta,
                                    void* scale_shift, void* part, void* counter, int B, int HW,
                                    int C, int G, int lanes, int tile_px, int ntiles, int nchunk,
                                    int stages, int cluster, float eps, void* stream) {
  const Plan p{B, HW, C, G, lanes, tile_px, ntiles, nchunk, stages, cluster};
  return launch<float, false>(x, gamma, beta, scale_shift, nullptr, part, counter, p, eps, 0,
                              stream);
}

// GroupNorm (+ SiLU) in one launch, every block resident at once: out [B, HW,
// C] bf16; part [B, nchunk / cluster, G] float2 of workspace; counter [4 B]
// uint32, zero before the call and zero after it.
extern "C" int group_norm_bf16(const void* x, const void* gamma, const void* beta, void* out,
                               void* part, void* counter, int B, int HW, int C, int G, int lanes,
                               int tile_px, int ntiles, int nchunk, int stages, int cluster,
                               float eps, int silu, void* stream) {
  const Plan p{B, HW, C, G, lanes, tile_px, ntiles, nchunk, stages, cluster};
  return launch<__nv_bfloat16, true>(x, gamma, beta, nullptr, out, part, counter, p, eps, silu,
                                     stream);
}
// The same for x and out in fp32.
extern "C" int group_norm_f32(const void* x, const void* gamma, const void* beta, void* out,
                              void* part, void* counter, int B, int HW, int C, int G, int lanes,
                              int tile_px, int ntiles, int nchunk, int stages, int cluster,
                              float eps, int silu, void* stream) {
  const Plan p{B, HW, C, G, lanes, tile_px, ntiles, nchunk, stages, cluster};
  return launch<float, true>(x, gamma, beta, nullptr, out, part, counter, p, eps, silu, stream);
}
