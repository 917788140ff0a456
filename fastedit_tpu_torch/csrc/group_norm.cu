// GroupNorm (+ optional SiLU) over NHWC bf16 or fp32, fp32 statistics with a
// two-pass (centred) variance, in two launches; and the statistics launch
// alone, for the fused resnet conv's prologue.  Every kernel is a template
// over the element type T: a thread owns 8 channels of a pixel, one 16-byte
// vector in bf16 and two in fp32 (Vec8<T>), so the schedule's thread layout
// is the same for both and only the bytes of a stage double in fp32.
//
// Replaces the TPU kernel fastedit_tpu/ops/fused_groupnorm.py
// (`fused_group_norm` -> `_fused_gn_4d` / `_gn_kernel`), and serves the XLA
// function fastedit_tpu/ops/groupnorm.py `group_norm_scale_shift`.  The TPU
// kernel walks its grid in order and carries the group sums in VMEM scratch
// across three phases over the same tiles: sums, centred sum of squares (the
// one-pass E[x^2] - E[x]^2 cancels in fp32 when |mean| >> std), then
// normalise + affine (+ SiLU).  On the card, blocks run in parallel and in no
// order, so:
//
//   gn_stats_kernel  grid (chunk, batch item).  A block streams its chunk of
//                    whole pixels (all C channels) through a ring of shared
//                    memory stages, one 1-D bulk copy (TMA) per stage, so x is
//                    read from device memory once.  Each thread takes its
//                    values of a stage into registers, computes their mean and
//                    then their centred M2 per channel (two passes over the
//                    copy on chip), and merges them into its running (n, mean,
//                    M2) (Chan's merge); at the chunk's end the block
//                    merges its threads' statistics per group, in a fixed
//                    order, and writes the chunk's (mean, M2) to a small
//                    workspace.  The last block of a batch item to finish (a
//                    __threadfence and an atomic counter, which that block
//                    sets back to 0, so the kernel is right under a CUDA
//                    graph's replays) merges the chunks in a fixed order and
//                    writes scale = rstd * gamma, shift = beta - mean * scale
//                    per (batch item, channel).
//   gn_apply_kernel  y = x * scale + shift (+ SiLU with __fdividef), one
//                    rounding to T (none in fp32): the second read of x.
//   resident route   where the ring holds each chunk whole and the blocks fit
//                    the SMs (ops/fused_groupnorm.plan), gn_stats_kernel<true>
//                    alone, as a cooperative launch: the blocks of a batch
//                    item meet at a barrier, each merges the chunks itself and
//                    writes its output from shared memory, so x is read once
//                    (the denoise loop's shapes, up to ~26 MB).
//
// Every sum is taken in a fixed order (no float atomics), so two launches give
// the same bits.  What bounds it on an H100: bytes.  At ~5 FLOPs per element
// it lies far below the card's ridge point; the least time is one read of x
// and one write of the output at HBM bandwidth; the kernels read x twice.
//
// Thread layout (both kernels): with VC = C / 8 vectors of 8 channels per
// pixel, a block has lanes * VC data threads (lanes = 512 / VC, at least one);
// thread t owns channel vector t % VC of every lanes-th pixel, from pixel t /
// VC on.  In a stage of whole pixels that is vector t, t + NT, t + 2 NT, ...
// (NT = lanes * VC): neighbouring threads read neighbouring 16 (bf16) or 32
// (fp32) bytes.  No block-wide step
// per stage but the barrier before a stage is refilled: a thread's statistics
// stay in its registers until the chunk ends.  Then they go to shared memory,
// [lanes][C], and each group's lanes * C / G entries are merged by a run of
// lanes of one warp, all groups at once (group_merge: lane-strided sums, then
// a butterfly of shuffles, in double).  The schedule (lanes, stage size, stages, chunks, the apply grid)
// comes from ops/fused_groupnorm.plan.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int MAX_THREADS = 512;
constexpr int MAX_C = 4096;         // 512 vectors; [lanes][C] partials fill MAX_C floats
constexpr int MAX_G = 128;
constexpr int MAX_STAGES = 4;
constexpr int RING_BYTES = 192 * 1024;  // the stages of one block

struct Plan {  // ops/fused_groupnorm.plan, as the wrapper passes it
  int B, HW, C, G;
  int lanes;            // pixels a block covers side by side
  int tile_px;          // pixels per stage
  int tiles_per_chunk;  // stages a statistics block streams
  int nchunk;           // statistics blocks per batch item
  int stages;           // ring depth
  int apply_px;         // pixels per apply block
  int napply;           // apply blocks per batch item
};

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

// The chunks' statistics of batch item b, part[b, :, :], merged per group by
// the whole block: staged in shared memory in one sweep (nchunk x G <=
// MAX_C), then group_merge.  Leaves the group's mean in mean_out[g]
// and its rstd in rstd_out[g] (the staging arrays themselves).
__device__ void merge_chunks(const float2* part, const Plan& p, int b, float eps,
                             float* mean_out, float* rstd_out) {
  const int t = threadIdx.x, G = p.G, cg = p.C / G;
  for (int i = t; i < p.nchunk * G; i += blockDim.x) {
    const float2 pk = __ldcg(&part[(long long)b * p.nchunk * G + i]);
    mean_out[i] = pk.x;
    rstd_out[i] = pk.y;
  }
  __syncthreads();
  const int sub = merge_lanes(G), sl = t & (sub - 1);
  const int g = (t >> 5) * (32 / sub) + (t & 31) / sub;
  const long long chunk_px = (long long)p.tiles_per_chunk * p.tile_px;
  double n, mu, q;
  group_merge(
      g < G ? p.nchunk : 0, sub, sl,
      [&](int k, double& nk, double& mk, double& qk) {
        nk = (double)min(chunk_px, (long long)p.HW - k * chunk_px) * cg;
        mk = mean_out[k * G + g], qk = rstd_out[k * G + g];
      },
      n, mu, q);
  __syncthreads();  // the staged chunks are read: their space takes the results
  if (g < G && sl == 0) {
    mean_out[g] = (float)mu;
    rstd_out[g] = (float)(1.0 / sqrt(q / n + (double)eps));
  }
  __syncthreads();
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

// Grid (nchunk, B), lanes * VC threads rounded up to warps.  Each thread
// keeps (n, mean, M2) of its eight channels over its pixels of the chunk: per
// stage the mean and centred M2 of its (up to `vecs`) values, from registers,
// merged into the running ones.  Then the block merges them per group (entries
// lane-row major) into part[b, chunk, g] = (mean, M2), and the last block of
// batch item b merges the chunks and writes scale_shift[0, b, :] and
// scale_shift[1, b, :].
//
// RESIDENT (a cooperative launch, every block resident at once, each chunk
// held whole by its ring: stages == tiles_per_chunk): instead of a last block,
// every block of batch item b arrives at counter[b] and waits for the others
// (a barrier per batch item), merges the chunks itself (the same order as the
// last block, so the same bits), and normalises its chunk from shared memory
// into out: one read of x and one launch.  The last block to leave sets
// counter[b] and counter[B + b] back to 0.
template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    gn_stats_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, float* __restrict__ scale_shift,
                    float2* part, unsigned int* counter, const Plan p, float eps,
                    T* __restrict__ out, int silu) {
  using Raw = typename Vec8<T>::Raw;
  constexpr int VECS = Vec8<T>::MAX_VECS;
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ float red_mean[MAX_C], red_m2[MAX_C];  // [lanes][C]; then [G] each in the last block
  __shared__ float lane_n[MAX_THREADS];             // pixels of the chunk each lane row saw
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  __shared__ int last;

  const int t = threadIdx.x, b = blockIdx.y, chunk = blockIdx.x;
  const int C = p.C, G = p.G, cg = C / G, vc = C / 8, nt = p.lanes * vc;
  const int vecs = p.tile_px / p.lanes, tile0 = chunk * p.tiles_per_chunk;
  const int ntile = min(p.tiles_per_chunk, (p.HW + p.tile_px - 1) / p.tile_px - tile0);
  const int stage_bytes = p.tile_px * C * (int)sizeof(T);
  const char* xb = reinterpret_cast<const char*>(x + (long long)b * p.HW * C);

  auto pixels = [&](int i) { return min(p.tile_px, p.HW - (tile0 + i) * p.tile_px); };
  auto issue = [&](int i) {  // thread 0: tile i of the chunk into stage i % stages
    const int s = i % p.stages, bytes = pixels(i) * C * (int)sizeof(T);
    mbar_expect_tx(smem_u32(&full[s]), bytes);
    bulk_load(smem_u32(ring + s * stage_bytes), xb + (long long)(tile0 + i) * stage_bytes, bytes,
              smem_u32(&full[s]));
  };
  if (t == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < min(p.stages, ntile); ++i) issue(i);
  }
  __syncthreads();

  float cnt = 0.f, mean[8], m2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) mean[e] = m2[e] = 0.f;
  for (int i = 0; i < ntile; ++i) {
    const int s = i % p.stages, nvec = pixels(i) * vc;
    mbar_wait(smem_u32(&full[s]), (i / p.stages) & 1);
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
    __syncthreads();  // every thread holds its part of stage s: refill it
    if (t == 0 && i + p.stages < ntile) issue(i + p.stages);
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
    if (t % vc == 0) lane_n[t / vc] = cnt;
  }
  __syncthreads();

  // Group g: lanes [sub * (g % per_warp), + sub) of warp g / per_warp.
  const int sub = merge_lanes(G), per_warp = 32 / sub, sl = t & (sub - 1);
  const int g = (t >> 5) * per_warp + (t & 31) / sub;
  {
    double n, mu, q;
    group_merge(
        g < G ? p.lanes * cg : 0, sub, sl,
        [&](int k, double& nk, double& mk, double& qk) {
          const int l = k / cg, c = l * C + g * cg + (k - l * cg);
          nk = lane_n[l], mk = red_mean[c], qk = red_m2[c];
        },
        n, mu, q);
    if (g < G && sl == 0) part[((long long)b * p.nchunk + chunk) * G + g] = make_float2(mu, q);
  }
  __threadfence();
  __syncthreads();
  if constexpr (RESIDENT) {
    if (t == 0) {
      atomicAdd(&counter[b], 1u);
      while (load_acquire(&counter[b]) < (unsigned)p.nchunk) __nanosleep(32);
    }
    __syncthreads();
    merge_chunks(part, p, b, eps, red_mean, red_m2);
    if (t == 0 && atomicAdd(&counter[p.B + b], 1u) == (unsigned)(p.nchunk - 1)) {
      counter[b] = 0u;  // every block of b has passed the barrier
      counter[p.B + b] = 0u;
    }
    if (t >= nt) return;
    const int c0 = (t % vc) * 8;
    float sc[8], sh[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int g = (c0 + e) / cg;
      sc[e] = red_m2[g] * gamma[c0 + e];
      sh[e] = beta[c0 + e] - red_mean[g] * sc[e];
    }
    Raw* ob = reinterpret_cast<Raw*>(out + (long long)b * p.HW * C);
    for (int i = 0; i < ntile; ++i) {
      const Raw* tile = reinterpret_cast<const Raw*>(ring + i * stage_bytes);
      Raw* ot = ob + (long long)(tile0 + i) * p.tile_px * vc;
      const int nvec = pixels(i) * vc;
      for (int v = t; v < nvec; v += nt) ot[v] = affine8(tile[v], sc, sh, silu);
    }
    return;
  }
  if (t == 0) last = atomicAdd(&counter[b], 1u) == (unsigned)(p.nchunk - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();

  merge_chunks(part, p, b, eps, red_mean, red_m2);  // the last block
  float* scale = scale_shift + (long long)b * C;
  float* shift = scale_shift + ((long long)p.B + b) * C;
  for (int c = t; c < C; c += blockDim.x) {
    const int g = c / cg;
    const float sc = red_m2[g] * gamma[c];
    scale[c] = sc;
    shift[c] = beta[c] - red_mean[g] * sc;
  }
  if (t == 0) counter[b] = 0u;
}

// Grid (napply, B): block k of batch item b normalises pixels [k * apply_px,
// (k + 1) * apply_px), four pixels per thread in flight.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ scale_shift,
                    T* __restrict__ out, const Plan p, int silu) {
  using Raw = typename Vec8<T>::Raw;
  const int t = threadIdx.x, b = blockIdx.y;
  const int C = p.C, vc = C / 8, lanes = p.lanes;
  if (t >= lanes * vc) return;
  const int c0 = (t % vc) * 8;
  float sc[8], sh[8];
  const float* scale = scale_shift + (long long)b * C + c0;
  const float* shift = scale_shift + ((long long)p.B + b) * C + c0;
#pragma unroll
  for (int e = 0; e < 8; e += 4) {
    *reinterpret_cast<float4*>(sc + e) = *reinterpret_cast<const float4*>(scale + e);
    *reinterpret_cast<float4*>(sh + e) = *reinterpret_cast<const float4*>(shift + e);
  }
  const int p0 = blockIdx.x * p.apply_px, p1 = min(p0 + p.apply_px, p.HW);
  const Raw* xs = reinterpret_cast<const Raw*>(x + (long long)b * p.HW * C + c0);
  Raw* os = reinterpret_cast<Raw*>(out + (long long)b * p.HW * C + c0);
  int px = p0 + t / vc;
  for (; px + 3 * lanes < p1; px += 4 * lanes) {
    Raw raw[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) raw[j] = xs[(long long)(px + j * lanes) * vc];
#pragma unroll
    for (int j = 0; j < 4; ++j) os[(long long)(px + j * lanes) * vc] = affine8(raw[j], sc, sh, silu);
  }
  for (; px < p1; px += lanes) os[(long long)px * vc] = affine8(xs[(long long)px * vc], sc, sh, silu);
}

int block_threads(const Plan& p) { return (p.lanes * (p.C / 8) + 31) / 32 * 32; }

// The plan's numbers, checked against what the kernels take; 0 or a CUDA error.
template <typename T>
int check(const Plan& p, bool apply) {
  const int ntiles = (p.HW + p.tile_px - 1) / max(p.tile_px, 1);
  const bool ok =
      p.B >= 1 && p.HW >= 1 && p.C % 8 == 0 && p.C <= MAX_C && p.G >= 1 && p.G <= MAX_G &&
      p.C % p.G == 0 && p.lanes >= 1 && p.lanes * (p.C / 8) <= MAX_THREADS &&
      block_threads(p) >= p.G && p.tile_px >= 1 && p.tile_px % p.lanes == 0 &&
      p.tile_px / p.lanes <= Vec8<T>::MAX_VECS &&
      p.stages >= 1 && p.stages <= MAX_STAGES &&
      (long long)p.stages * p.tile_px * p.C * (int)sizeof(T) <= RING_BYTES &&
      p.tiles_per_chunk >= 1 &&
      p.nchunk >= 1 && p.nchunk * p.G <= MAX_C && (long long)p.nchunk * p.tiles_per_chunk >= ntiles &&
      (long long)(p.nchunk - 1) * p.tiles_per_chunk < ntiles && p.nchunk <= 65535 &&
      p.B <= 65535 &&
      (!apply || (p.apply_px >= 1 && p.napply >= 1 && (long long)p.napply * p.apply_px >= p.HW &&
                  (long long)(p.napply - 1) * p.apply_px < p.HW));
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Raise the statistics kernel's dynamic shared memory limit once per device.
template <typename T, bool RESIDENT>
int configure() {
  static unsigned long long configured = 0;  // one bit per device
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!(configured >> (device & 63) & 1)) {
    e = cudaFuncSetAttribute(gn_stats_kernel<T, RESIDENT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, RING_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured |= 1ull << (device & 63);
  }
  return 0;
}

template <typename T>
int launch_stats(const void* x, const void* gamma, const void* beta, void* scale_shift,
                 void* part, void* counter, const Plan& p, float eps, cudaStream_t s) {
  if (int err = configure<T, false>()) return err;
  gn_stats_kernel<T, false>
      <<<dim3(p.nchunk, p.B), block_threads(p), p.stages * p.tile_px * p.C * (int)sizeof(T),
         s>>>(static_cast<const T*>(x), static_cast<const float*>(gamma),
              static_cast<const float*>(beta), static_cast<float*>(scale_shift),
              static_cast<float2*>(part), static_cast<unsigned int*>(counter), p, eps, nullptr,
              0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int stats(const void* x, const void* gamma, const void* beta, void* scale_shift, void* part,
          void* counter, const Plan& p, float eps, void* stream) {
  if (int err = check<T>(p, false)) return err;
  return launch_stats<T>(x, gamma, beta, scale_shift, part, counter, p, eps,
                         static_cast<cudaStream_t>(stream));
}

template <typename T>
int resident(const void* x, const void* gamma, const void* beta, void* out, void* part,
             void* counter, const Plan& p, float eps, int silu, void* stream) {
  if (int err = check<T>(p, false)) return err;
  if (p.stages != p.tiles_per_chunk) return static_cast<int>(cudaErrorInvalidValue);
  if (int err = configure<T, true>()) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.nchunk, p.B);
  cfg.blockDim = dim3(block_threads(p));
  cfg.dynamicSmemBytes = p.stages * p.tile_px * p.C * sizeof(T);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, gn_stats_kernel<T, true>, static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(nullptr), static_cast<float2*>(part),
      static_cast<unsigned int*>(counter), p, eps, static_cast<T*>(out), silu);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T>
int two_launch(const void* x, const void* gamma, const void* beta, void* out, void* scale_shift,
               void* part, void* counter, const Plan& p, float eps, int silu, void* stream) {
  if (int err = check<T>(p, true)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int err = launch_stats<T>(x, gamma, beta, scale_shift, part, counter, p, eps, s))
    return err;
  gn_apply_kernel<T><<<dim3(p.napply, p.B), block_threads(p), 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale_shift), static_cast<T*>(out), p,
      silu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The statistics launch alone: scale_shift [2, B, C] fp32 (scale, then
// shift).  x [B, HW, C] bf16, 16-byte aligned; gamma, beta [C] fp32; part [B,
// nchunk, G] float2 of workspace; counter [B] uint32, zero before the call and
// zero after it.
extern "C" int group_norm_stats_bf16(const void* x, const void* gamma, const void* beta,
                                     void* scale_shift, void* part, void* counter, int B, int HW,
                                     int C, int G, int lanes, int tile_px, int tiles_per_chunk,
                                     int nchunk, int stages, float eps, void* stream) {
  const Plan p{B, HW, C, G, lanes, tile_px, tiles_per_chunk, nchunk, stages, 0, 0};
  return stats<__nv_bfloat16>(x, gamma, beta, scale_shift, part, counter, p, eps, stream);
}
// The same for x in fp32.
extern "C" int group_norm_stats_f32(const void* x, const void* gamma, const void* beta,
                                    void* scale_shift, void* part, void* counter, int B, int HW,
                                    int C, int G, int lanes, int tile_px, int tiles_per_chunk,
                                    int nchunk, int stages, float eps, void* stream) {
  const Plan p{B, HW, C, G, lanes, tile_px, tiles_per_chunk, nchunk, stages, 0, 0};
  return stats<float>(x, gamma, beta, scale_shift, part, counter, p, eps, stream);
}

// GroupNorm (+ SiLU) in one cooperative launch (the plan's resident route:
// stages == tiles_per_chunk, every block resident at once): part [B, nchunk,
// G] float2 of workspace; counter [2 B] uint32, zero before the call and zero
// after it.
extern "C" int group_norm_resident_bf16(const void* x, const void* gamma, const void* beta,
                                        void* out, void* part, void* counter, int B, int HW,
                                        int C, int G, int lanes, int tile_px,
                                        int tiles_per_chunk, int nchunk, int stages, float eps,
                                        int silu, void* stream) {
  const Plan p{B, HW, C, G, lanes, tile_px, tiles_per_chunk, nchunk, stages, 0, 0};
  return resident<__nv_bfloat16>(x, gamma, beta, out, part, counter, p, eps, silu, stream);
}
// The same for x and out in fp32.
extern "C" int group_norm_resident_f32(const void* x, const void* gamma, const void* beta,
                                       void* out, void* part, void* counter, int B, int HW, int C,
                                       int G, int lanes, int tile_px, int tiles_per_chunk,
                                       int nchunk, int stages, float eps, int silu,
                                       void* stream) {
  const Plan p{B, HW, C, G, lanes, tile_px, tiles_per_chunk, nchunk, stages, 0, 0};
  return resident<float>(x, gamma, beta, out, part, counter, p, eps, silu, stream);
}

// GroupNorm (+ SiLU): the statistics launch into scale_shift (workspace, [2,
// B, C] fp32), then the apply launch into out [B, HW, C] bf16.
extern "C" int group_norm_bf16(const void* x, const void* gamma, const void* beta, void* out,
                               void* scale_shift, void* part, void* counter, int B, int HW, int C,
                               int G, int lanes, int tile_px, int tiles_per_chunk, int nchunk,
                               int stages, int apply_px, int napply, float eps, int silu,
                               void* stream) {
  const Plan p{B, HW, C, G, lanes, tile_px, tiles_per_chunk, nchunk, stages, apply_px, napply};
  return two_launch<__nv_bfloat16>(x, gamma, beta, out, scale_shift, part, counter, p, eps, silu,
                                   stream);
}
// The same for x and out in fp32.
extern "C" int group_norm_f32(const void* x, const void* gamma, const void* beta, void* out,
                              void* scale_shift, void* part, void* counter, int B, int HW, int C,
                              int G, int lanes, int tile_px, int tiles_per_chunk, int nchunk,
                              int stages, int apply_px, int napply, float eps, int silu,
                              void* stream) {
  const Plan p{B, HW, C, G, lanes, tile_px, tiles_per_chunk, nchunk, stages, apply_px, napply};
  return two_launch<float>(x, gamma, beta, out, scale_shift, part, counter, p, eps, silu,
                           stream);
}
