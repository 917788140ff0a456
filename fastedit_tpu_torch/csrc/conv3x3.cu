// 3x3 SAME stride-1 convolution, NHWC bf16, as an implicit GEMM on the
// tensor cores (mma.sync m16n8k16, fp32 accumulation).
//
// Replaces the TPU kernel fastedit_tpu/ops/conv3x3.py (`conv3x3` ->
// `_conv3x3_call` / `_conv_kernel`): the same function, bias add in fp32,
// optional SiLU in fp32, one rounding to bf16 at the end.
//
// What bounds it on an H100: operations.  The main path's convs do
// 2*M*Cout*9*Cin FLOPs on M = B*H*W pixels; at the UNet shapes that is
// 150-300 FLOPs per byte moved, at or above the card's bf16 ridge point
// (~295 FLOP/byte), so the tensor cores, not HBM, are the limit.
//
// Design: GEMM view  out[m, n] = sum_k A[m, k] * Wt[n, k]  with
//   m = pixel (b, y, x), n = output channel, k = (tap, cin).
// A is never materialised: each K step (one tap, 64 input channels) loads the
// shifted input rows straight from the NHWC tensor with 16-byte cp.async
// copies; pixels that fall into the zero padding ring, channels past Cin and
// rows past M are zero-filled by the copy itself (src-size 0), so ragged Cin
// and the image border need no padded copy in HBM.  The weight is read in
// OHWI order (torch's OIHW in channels_last memory) so both operands are
// K-contiguous, the layout mma.sync's row.col form wants.  Tiles are
// 128 pixels x 128 output channels x 64 k in a 3-stage cp.async ring in
// dynamic shared memory (two tiles in flight while one is multiplied);
// 8 warps each own a 64x32 sub-tile and read their fragments with
// ldmatrix.  The k loop walks (tap, channel chunk) incrementally, so a
// stage's copies cost no integer division.  The epilogue works on the
// accumulator registers directly and masks ragged Cout (320, 8, 4, 3) per
// element.  wgmma/TMA would go further; that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // output pixels per block
constexpr int BN = 128;        // output channels per block
constexpr int BK = 64;         // k (input channels of one tap) per stage
constexpr int STAGES = 3;      // cp.async ring depth
constexpr int LDS = BK + 8;    // smem row stride in bf16 (144 B: ldmatrix conflict-free)
constexpr int VPR = BK / 8;    // 16-byte vectors per tile row
constexpr int RPT = BM * VPR / 256;  // tile rows each thread copies per operand
constexpr int NTHREADS = 256;  // 8 warps: 2 along M x 4 along N
constexpr int WM = 64;         // warp tile rows
constexpr int WN = 32;         // warp tile cols
constexpr int MT = WM / 16;    // m16 tiles per warp
constexpr int NT = WN / 8;     // n8 tiles per warp
constexpr int STAGE_ELEMS = (BM + BN) * LDS;
constexpr size_t SMEM_BYTES = sizeof(__nv_bfloat16) * STAGES * STAGE_ELEMS;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 bf16 matrices; lane l supplies the address of row (l & 7) of
// matrix (l >> 3) and receives its share of each in r[0..3].
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const __nv_bfloat16* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__global__ void __launch_bounds__(NTHREADS, 2)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x,   // [B, H, W, Cin]
               const __nv_bfloat16* __restrict__ w,   // [Cout, 3, 3, Cin]
               const float* __restrict__ bias,        // [Cout] or null
               __nv_bfloat16* __restrict__ out,       // [B, H, W, Cout]
               int B, int H, int W, int Cin, int Cout, int silu) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // Stage s holds A (BM rows) then B (BN rows), each row LDS wide.
  auto a_tile = [&](int s) { return smem + s * STAGE_ELEMS; };
  auto b_tile = [&](int s) { return smem + s * STAGE_ELEMS + BM * LDS; };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // 0..1
  const int wn = warp & 3;   // 0..3
  const int g = lane >> 2;   // mma group id
  const int tg = lane & 3;   // thread in group

  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // Each thread copies RPT 16-byte vectors of A and of B per stage: rows
  // (tid / VPR) + (256 / VPR) * i, vector (tid % VPR) of the 64-wide k.
  const int vec = tid % VPR;
  const int row0 = tid / VPR;
  constexpr int ROW_STEP = NTHREADS / VPR;
  int ay[RPT], ax[RPT], apix[RPT];  // apix: pixel index of (b, 0, 0); -1 past M
  for (int i = 0; i < RPT; ++i) {
    const long long m = m0 + row0 + ROW_STEP * i;
    const long long mm = m < M ? m : 0;
    const int b = (int)(mm / ((long long)H * W));
    const int r = (int)(mm - (long long)b * H * W);
    ay[i] = r / W;
    ax[i] = r - ay[i] * W;
    apix[i] = m < M ? b * H * W : -1;
  }

  const int ck = (Cin + BK - 1) / BK;  // k chunks per tap
  const int KT = 9 * ck;

  // The next k tile to copy, as (tap, first channel); copies run in k order.
  int ld_tap = 0, ld_c = 0;
  auto load_stage = [&](int stage) {
    const int c = ld_c + vec * 8;
    const int dy = ld_tap / 3 - 1, dx = ld_tap % 3 - 1;
    const bool cin_ok = c < Cin;
    __nv_bfloat16* as = a_tile(stage);
    __nv_bfloat16* bs = b_tile(stage);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int yy = ay[i] + dy, xx = ax[i] + dx;
      const bool ok = apix[i] >= 0 && cin_ok && yy >= 0 && yy < H && xx >= 0 && xx < W;
      const __nv_bfloat16* src =
          ok ? x + (((long long)apix[i] + yy * W + xx) * Cin + c) : x;
      cp_async16(as + (row0 + ROW_STEP * i) * LDS + vec * 8, src, ok);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int n = n0 + row0 + ROW_STEP * i;
      const bool ok = n < Cout && cin_ok;
      const __nv_bfloat16* src = ok ? w + (((long long)n * 9 + ld_tap) * Cin + c) : w;
      cp_async16(bs + (row0 + ROW_STEP * i) * LDS + vec * 8, src, ok);
    }
    ld_c += BK;
    if (ld_c >= Cin) {
      ld_c = 0;
      ++ld_tap;
    }
  };

  float acc[MT][NT][4];
  for (int i = 0; i < MT; ++i)
    for (int j = 0; j < NT; ++j)
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  // Prologue: STAGES-1 tiles in flight.  Every iteration commits one group
  // (empty past the end), so "at most STAGES-2 pending" means tile kt landed.
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s);
    cp_async_commit();
  }
  // ldmatrix lane offsets: A rows (lane & 15), k half (lane >> 4); B rows
  // ((lane >> 4) * 8 + (lane & 7)), k half ((lane >> 3) & 1).
  const int a_row = lane & 15, a_k = (lane >> 4) * 8;
  const int b_row = (lane >> 4) * 8 + (lane & 7), b_k = ((lane >> 3) & 1) * 8;

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt visible to all; stage (kt - 1) free to refill
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_stage(nk % STAGES);
    cp_async_commit();

    const __nv_bfloat16* as = a_tile(kt % STAGES);
    const __nv_bfloat16* bs = b_tile(kt % STAGES);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], as + (wm * WM + i * 16 + a_row) * LDS + ks + a_k);
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t r[4];
        ldmatrix_x4(r, bs + (wn * WN + jp * 16 + b_row) * LDS + ks + b_k);
        bf[2 * jp][0] = r[0];
        bf[2 * jp][1] = r[1];
        bf[2 * jp + 1][0] = r[2];
        bf[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();

  // Epilogue straight from the accumulators: c0,c1 sit at row g, cols
  // 2*tg, 2*tg+1 of each m16n8 tile; c2,c3 at row g+8.
  const bool pair_store = (Cout & 1) == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm * WM + i * 16 + g + half * 8;
      if (m >= M) continue;
      __nv_bfloat16* orow = out + m * Cout;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + wn * WN + j * 8 + tg * 2;
        float v[2];
        for (int e = 0; e < 2; ++e) {
          float t = acc[i][j][half * 2 + e];
          if (bias != nullptr && n + e < Cout) t += bias[n + e];
          if (silu) t = t / (1.f + __expf(-t));
          v[e] = t;
        }
        if (pair_store && n + 1 < Cout) {
          __nv_bfloat162 pr;
          pr.x = __float2bfloat16(v[0]);
          pr.y = __float2bfloat16(v[1]);
          *reinterpret_cast<__nv_bfloat162*>(orow + n) = pr;
        } else {
          if (n < Cout) orow[n] = __float2bfloat16(v[0]);
          if (n + 1 < Cout) orow[n + 1] = __float2bfloat16(v[1]);
        }
      }
    }
  }
}

}  // namespace

extern "C" int conv3x3_bf16(const void* x, const void* w, const void* bias, void* out,
                            int B, int H, int W, int Cin, int Cout, int silu,
                            void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(conv3x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const long long M = (long long)B * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  conv3x3_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), B, H, W, Cin,
      Cout, silu);
  return static_cast<int>(cudaGetLastError());
}
