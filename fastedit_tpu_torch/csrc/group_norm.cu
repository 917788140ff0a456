// GroupNorm (+ optional SiLU) over NHWC bf16, fp32 statistics, two-pass
// variance.
//
// Replaces the TPU kernel fastedit_tpu/ops/fused_groupnorm.py
// (`fused_group_norm` -> `_fused_gn_4d` / `_gn_kernel`).  The TPU kernel
// walks its grid in order and carries the group sums in VMEM scratch across
// three phases over the same tiles: sums, centred sum of squares (the two-pass
// variance: the one-pass E[x^2] - E[x]^2 cancels in fp32 when |mean| >> std),
// then normalise + affine (+ SiLU).  On the card, blocks run in no order, so
// each phase is its own launch and the cross-block reduction goes through
// memory instead of atomics:
//
//   gn_partial_kernel (pass 0)  per (chunk of pixels, batch item): per-group
//                               sums of x -> part[0, b, chunk, g]
//   gn_finalize_kernel (pass 0) per batch item: mean[b, g] = sum of the
//                               chunks' partials (in fp64, fixed order) / n
//   gn_partial_kernel (pass 1)  per-group sums of (x - mean)^2 -> part[1, ...]
//   gn_finalize_kernel (pass 1) rstd[b, g] = rsqrt(sum / n + eps)
//   gn_apply_kernel             y = x * scale + shift with scale =
//                               rstd * gamma, shift = beta - mean * scale
//                               (the TPU kernel's affine), optional SiLU, one
//                               rounding to bf16
//
// The order of every sum is fixed, so the result does not change from run to
// run.  What bounds it on an H100: bytes.  It reads x three times and writes
// the output once (as the TPU kernel does) at 5 FLOPs per element, far below
// the card's ridge point; the least time is one read and one write at HBM
// bandwidth.
//
// Thread layout: a block of 256 threads covers all C channels of some pixels
// at once in 16-byte vectors (8 channels), so loads are contiguous and
// coalesced.  With VC = C / 8 vectors per pixel spread over VS = ceil(VC /
// nv) slots (nv = 1, or 2 above 2048 channels), thread t owns vectors
// (t % VS) + k * VS of every (256 / VS)-th pixel of the chunk.  Channel
// sums are reduced over the threads in shared memory, then summed into
// groups (a group may span vectors, and a vector groups: cg = C / G is 4 to
// 80 here).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_NV = 2;                     // vectors per thread per pixel
constexpr int MAX_C = 8 * MAX_NV * NTHREADS;  // 4096 channels
constexpr int MAX_G = 128;

struct GnArgs {
  const __nv_bfloat16* x;  // [B, HW, C]
  const float* gamma;      // [C]
  const float* beta;       // [C]
  __nv_bfloat16* out;      // [B, HW, C]
  float* part;             // [2, B, nchunk, G]
  float* stats;            // [2, B, G]: mean, then rstd
  int B, HW, C, G, nchunk, silu;
  float eps;
};

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 v = __bfloat1622float2(h[e]);
    f[2 * e] = v.x;
    f[2 * e + 1] = v.y;
  }
}

// This thread's slot, lane, lane count and vectors per pixel.
struct Layout {
  int vc, nv, vs, lanes, slot, lane;
  __device__ Layout(int C, int t) {
    vc = C / 8;
    nv = (vc + NTHREADS - 1) / NTHREADS;
    vs = (vc + nv - 1) / nv;
    lanes = NTHREADS / vs;
    slot = t % vs;
    lane = t / vs;
  }
  __device__ int vec(int k) const { return slot + k * vs; }  // < vc where it exists
};

// Pixels [p0, p1) of this block's chunk.
__device__ __forceinline__ void chunk_range(const GnArgs& a, int chunk, int& p0, int& p1) {
  const int per = (a.HW + a.nchunk - 1) / a.nchunk;
  p0 = min(chunk * per, a.HW);
  p1 = min(p0 + per, a.HW);
}

// pass 0: sums of x; pass 1: sums of (x - mean)^2.  Grid (nchunk, B).
__global__ void __launch_bounds__(NTHREADS) gn_partial_kernel(const GnArgs a, int pass) {
  __shared__ float red[NTHREADS * MAX_NV * 8];
  __shared__ float chan[MAX_C];
  const int b = blockIdx.y, chunk = blockIdx.x, t = threadIdx.x;
  const int C = a.C, G = a.G, cg = C / G;
  const Layout L(C, t);
  int p0, p1;
  chunk_range(a, chunk, p0, p1);

  float mean[MAX_NV][8], acc[MAX_NV][8];
#pragma unroll
  for (int k = 0; k < MAX_NV; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = min(L.vec(k) * 8 + e, C - 1);
      mean[k][e] = pass ? a.stats[b * G + c / cg] : 0.f;
      acc[k][e] = 0.f;
    }
  if (L.lane < L.lanes) {
    const __nv_bfloat16* xb = a.x + (long long)b * a.HW * C;
    for (int px = p0 + L.lane; px < p1; px += L.lanes) {
#pragma unroll
      for (int k = 0; k < MAX_NV; ++k) {
        if (k >= L.nv || L.vec(k) >= L.vc) continue;
        float f[8];
        load8(xb + (long long)px * C + L.vec(k) * 8, f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = f[e] - mean[k][e];
          acc[k][e] += pass ? d * d : f[e];
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < MAX_NV; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) red[(t * MAX_NV + k) * 8 + e] = acc[k][e];
  __syncthreads();
  for (int c = t; c < C; c += NTHREADS) {  // channel c: vector v = slot + k * vs
    const int v = c / 8, k = v / L.vs, slot = v % L.vs;
    float s = 0.f;
    for (int l = 0; l < L.lanes; ++l) s += red[((l * L.vs + slot) * MAX_NV + k) * 8 + c % 8];
    chan[c] = s;
  }
  __syncthreads();
  if (t < G) {
    float s = 0.f;
    for (int c = t * cg; c < (t + 1) * cg; ++c) s += chan[c];
    a.part[(((long long)pass * a.B + b) * a.nchunk + chunk) * G + t] = s;
  }
}

// Grid (B), one thread per group: the chunks' partials summed in fp64.
__global__ void gn_finalize_kernel(const GnArgs a, int pass) {
  const int b = blockIdx.x, g = threadIdx.x;
  if (g >= a.G) return;
  const float* part = a.part + (((long long)pass * a.B + b) * a.nchunk) * a.G + g;
  double s = 0.0;
  for (int k = 0; k < a.nchunk; ++k) s += part[(long long)k * a.G];
  const double n = (double)a.HW * (a.C / a.G);
  a.stats[((long long)pass * a.B + b) * a.G + g] =
      pass ? rsqrtf((float)(s / n) + a.eps) : (float)(s / n);
}

// Grid (nchunk, B).
__global__ void __launch_bounds__(NTHREADS) gn_apply_kernel(const GnArgs a) {
  const int b = blockIdx.y, chunk = blockIdx.x, t = threadIdx.x;
  const int C = a.C, G = a.G, cg = C / G;
  const Layout L(C, t);
  if (L.lane >= L.lanes) return;
  int p0, p1;
  chunk_range(a, chunk, p0, p1);
  const long long base = (long long)b * a.HW * C;
  for (int k = 0; k < L.nv; ++k) {
    const int v = L.vec(k);
    if (v >= L.vc) break;
    float scale[8], shift[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = v * 8 + e, grp = b * G + c / cg;
      const float mean = a.stats[grp], rstd = a.stats[a.B * G + grp];
      scale[e] = rstd * a.gamma[c];
      shift[e] = a.beta[c] - mean * scale[e];
    }
    for (int px = p0 + L.lane; px < p1; px += L.lanes) {
      const long long off = base + (long long)px * C + v * 8;
      float f[8];
      load8(a.x + off, f);
      uint4 raw;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float y0 = f[2 * e] * scale[2 * e] + shift[2 * e];
        float y1 = f[2 * e + 1] * scale[2 * e + 1] + shift[2 * e + 1];
        if (a.silu) {
          y0 = __fdividef(y0, 1.f + __expf(-y0));  // no IEEE division slow path
          y1 = __fdividef(y1, 1.f + __expf(-y1));
        }
        h[e] = __floats2bfloat162_rn(y0, y1);
      }
      *reinterpret_cast<uint4*>(a.out + off) = raw;
    }
  }
}

}  // namespace

// x, out [B, HW, C] bf16 (C % 8 == 0, C <= 4096, G <= 128, C % G == 0);
// gamma, beta [C] fp32; work: 2 * B * (nchunk + 1) * G fp32.
extern "C" int group_norm_bf16(const void* x, const void* gamma, const void* beta, void* out,
                               void* work, int B, int HW, int C, int G, int nchunk, float eps,
                               int silu, void* stream) {
  if (C % 8 || C > MAX_C || G > MAX_G || C % G || nchunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  GnArgs a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part = static_cast<float*>(work);
  a.stats = a.part + 2LL * B * nchunk * G;
  a.B = B, a.HW = HW, a.C = C, a.G = G, a.nchunk = nchunk, a.silu = silu, a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(nchunk, B);
  for (int pass = 0; pass < 2; ++pass) {
    gn_partial_kernel<<<grid, NTHREADS, 0, s>>>(a, pass);
    gn_finalize_kernel<<<B, MAX_G, 0, s>>>(a, pass);
  }
  gn_apply_kernel<<<grid, NTHREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
