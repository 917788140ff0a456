// LayerNorm over the last dim of a [rows, C] bf16 or fp32 tensor, fp32
// statistics with a two-pass (centred) variance and an fp32 affine, in one
// launch that reads each row once and writes it once.
//
// Replaces no TPU kernel: the JAX package's LayerNorm (fastedit_tpu/models/
// layers.py) is plain jnp that XLA fuses into one pass.  Eager PyTorch runs the
// same math as about ten kernels (the fp32 copy of x, two means, six fp32
// elementwise passes, the cast back), ~68 bytes of traffic an element where
// 4 do in bf16 (8 in fp32).  It runs three times in every transformer block of
// the UNet and twice in every CLIP layer.
//
// Bound by bytes: every element is read once and written once, gamma and beta
// ([C] fp32) come through the read-only path and stay in L1/L2.  WPR warps
// (1, 2, 4 or 8) own a row and hold it in registers as 16-byte vectors (8
// bf16 or 4 fp32 values a vector), thread t of the row's 32 x WPR taking
// vectors t, t + 32 WPR, ... so that neighbouring lanes read neighbouring
// addresses.  The launch takes the fewest warps a row that leave each thread
// at most 3 vectors (NV): then a thread needs 32 registers, and 64 warps fit
// on an SM, the most it holds.  More vectors a thread cost registers, hence
// resident warps, and a grid of a wave and a fraction leaves the card
// half-empty in its last part (one warp a row of 1280 bf16 values read 68% of
// the bandwidth at [8, 1024, 1280], 5 vectors and 40 registers a thread).
// C = 640 bf16: one warp, 80 vectors; 1280: two warps; fp32 640 and 768: two,
// 1280: four.  A block is 8 warps, 8 / WPR rows; a row of several warps sums
// its warps' partials through shared memory, in warp order.
//
//   statistics   sum of the row (per thread, then a butterfly of shuffles and
//                the warps' partials in warp order: every thread ends with the
//                same bits), mean = sum / C; then the sum of
//                the squared deviations from the values still in registers,
//                var = that / C, rstd = rsqrtf(var + eps).
//   apply        y = ((x - mean) * rstd) * gamma + beta, each product and the
//                sum rounded on its own (no contraction into an FMA), as the
//                plain version's separate passes round them; one rounding to T
//                at the end (round to nearest even; none in fp32).
//
// Only the order of the sums differs from the plain version
// (ops/layer_norm.layer_norm_plain); the order is fixed, so two launches give
// the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;             // warps a block
constexpr int MAX_NV = 3;            // vectors a thread: 32 registers, 64 warps an SM
constexpr int MAX_CHANNELS = 2048;   // ops/layer_norm.MAX_CHANNELS

template <typename T>
__host__ __device__ constexpr int elems() { return 16 / static_cast<int>(sizeof(T)); }

__device__ __forceinline__ void unpack(const uint4& v, float* f, const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& v, float* f, const float*) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ uint4 pack(const float* f, const __nv_bfloat16*) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ uint4 pack(const float* f, const float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

// The sum of s over the row's 32 x WPR threads, the same bits in each: a
// butterfly within each warp, then (WPR > 1) the warps' partials in warp order
// through `part`.  Every thread of the block calls it the same number of times.
template <int WPR>
__device__ __forceinline__ float row_sum(float s, float* part) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if constexpr (WPR == 1) {
    return s;
  } else {
    const int w = threadIdx.x >> 5, first = w / WPR * WPR;
    if ((threadIdx.x & 31) == 0) part[w] = s;
    __syncthreads();
    s = part[first];
#pragma unroll
    for (int i = 1; i < WPR; ++i) s += part[first + i];
    __syncthreads();  // read before the next call writes
    return s;
  }
}

template <typename T, int WPR, int NV>
__global__ void __launch_bounds__(WARPS * 32)
    ln_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ y, int rows, int C, float eps) {
  constexpr int E = elems<T>(), LANES = 32 * WPR;
  __shared__ float part[WARPS];
  const int t = threadIdx.x % LANES;
  const int row = blockIdx.x * (WARPS / WPR) + threadIdx.x / LANES;
  if (WPR == 1 && row >= rows) return;  // a warp alone: no barrier to meet
  const int nvec = row < rows ? C / E : 0;  // past the last row: no loads, no stores
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * C);
  uint4* yr = reinterpret_cast<uint4*>(y + static_cast<size_t>(row) * C);

  uint4 v[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = j * LANES + t;
    v[j] = k < nvec ? __ldg(xr + k) : make_uint4(0u, 0u, 0u, 0u);
  }

  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (j * LANES + t < nvec) {
      float f[E];
      unpack(v[j], f, x);
#pragma unroll
      for (int e = 0; e < E; ++e) sum += f[e];
    }
  }
  const float mean = row_sum<WPR>(sum, part) / static_cast<float>(C);

  float m2 = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (j * LANES + t < nvec) {
      float f[E];
      unpack(v[j], f, x);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = __fsub_rn(f[e], mean);
        m2 = __fadd_rn(m2, __fmul_rn(d, d));
      }
    }
  }
  const float rstd = rsqrtf(row_sum<WPR>(m2, part) / static_cast<float>(C) + eps);

  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  const float4* b4 = reinterpret_cast<const float4*>(beta);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = j * LANES + t;
    if (k < nvec) {
      float f[E], g[E], b[E];
      unpack(v[j], f, x);
#pragma unroll
      for (int q = 0; q < E / 4; ++q) {
        const float4 gq = __ldg(g4 + k * (E / 4) + q), bq = __ldg(b4 + k * (E / 4) + q);
        g[4 * q] = gq.x, g[4 * q + 1] = gq.y, g[4 * q + 2] = gq.z, g[4 * q + 3] = gq.w;
        b[4 * q] = bq.x, b[4 * q + 1] = bq.y, b[4 * q + 2] = bq.z, b[4 * q + 3] = bq.w;
      }
#pragma unroll
      for (int e = 0; e < E; ++e)
        f[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[e], mean), rstd), g[e]), b[e]);
      yr[k] = pack(f, y);
    }
  }
}

// The instance for (wpr, nv), found by recursion over WPR = 1, 2, 4, 8 and
// NV = 1 .. MAX_NV.
template <typename T, int WPR, int NV>
int launch_instance(int wpr, int nv, const T* x, const float* gamma, const float* beta, T* y,
                    int rows, int C, float eps, cudaStream_t stream) {
  if constexpr (WPR > WARPS) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if constexpr (NV > MAX_NV) {
    return launch_instance<T, 2 * WPR, 1>(wpr, nv, x, gamma, beta, y, rows, C, eps, stream);
  } else {
    if (wpr != WPR || nv != NV)
      return launch_instance<T, WPR, NV + 1>(wpr, nv, x, gamma, beta, y, rows, C, eps, stream);
    constexpr int ROWS = WARPS / WPR;  // rows a block
    const unsigned blocks = static_cast<unsigned>((rows + ROWS - 1) / ROWS);
    ln_kernel<T, WPR, NV><<<blocks, WARPS * 32, 0, stream>>>(x, gamma, beta, y, rows, C, eps);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* y, int rows, int C,
           float eps, void* stream) {
  if (rows <= 0 || C <= 0 || C % 8 || C > MAX_CHANNELS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nvec = C / elems<T>();
  int wpr = 1;  // the fewest warps a row with at most MAX_NV vectors a thread
  while (wpr < WARPS && nvec > MAX_NV * 32 * wpr) wpr *= 2;
  const int nv = (nvec + 32 * wpr - 1) / (32 * wpr);
  return launch_instance<T, 1, 1>(wpr, nv, static_cast<const T*>(x),
                                  static_cast<const float*>(gamma),
                                  static_cast<const float*>(beta), static_cast<T*>(y), rows, C,
                                  eps, static_cast<cudaStream_t>(stream));
}

}  // namespace

// y [rows, C] = LayerNorm(x [rows, C]) * gamma + beta, in x's dtype.  x and y
// contiguous and 16-byte aligned, C a multiple of 8 up to 2048; gamma and beta
// [C] fp32, 16-byte aligned.
extern "C" int layer_norm_bf16(const void* x, const void* gamma, const void* beta, void* y,
                               int rows, int C, float eps, void* stream) {
  return launch<__nv_bfloat16>(x, gamma, beta, y, rows, C, eps, stream);
}
// The same for x and y in fp32.
extern "C" int layer_norm_f32(const void* x, const void* gamma, const void* beta, void* y,
                              int rows, int C, float eps, void* stream) {
  return launch<float>(x, gamma, beta, y, rows, C, eps, stream);
}
