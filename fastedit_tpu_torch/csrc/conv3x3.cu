// 3x3 convolutions, NHWC bf16, as implicit GEMMs on the tensor cores
// (mma.sync m16n8k16, fp32 accumulation).  One kernel body, four forms:
//
//   conv3x3_kernel        3x3 SAME stride 1; replaces fastedit_tpu/ops/conv3x3.py
//                         (`conv3x3` -> `_conv3x3_call` / `_conv_kernel`).
//   conv3x3_fused_kernel  the same conv with the resnet block's ops folded in;
//                         replaces fastedit_tpu/ops/conv_fused.py `conv3x3_fused`
//                         (`_fused_call` / `_fused_kernel`): a prologue
//                         silu(x * scale[b, c] + shift[b, c]) on the input tile
//                         (GroupNorm + SiLU with the statistics computed
//                         outside), a per-batch bias [B, Cout] (the time
//                         embedding folded in) and a skip-add epilogue.
//   conv3x3_up2_kernel    nearest-2x upsample + 3x3 SAME conv without the 4x
//                         tensor; replaces `conv3x3_up2` (`_up2_call` /
//                         `_up2_kernel`).  Output pixel (2i+p, 2j+q) is a 2x2
//                         conv of the low-res input with phase weights
//                         K[p, q] (3x3 taps summed in fp32 and rounded once to
//                         bf16): tap rows {i-1, i} for p = 0 and
//                         {i, i+1} for p = 1, the same for columns.
//                         blockIdx.z = 2p + q; 16/36 of the materialised
//                         conv's FLOPs.  up2_phase_weights_kernel folds the
//                         phase weights from the 3x3 ones, one thread per
//                         (Cout, Cin) pair, in the same call.
//   conv3x3_down2_kernel  stride-2 3x3 conv with padding (1, 1) or the VAE
//                         encoder's (0, 1); replaces `conv3x3_down2`
//                         (`_down2_call` / `_down2_kernel`).  The TPU kernel's
//                         parity-plane reshape exists to give it contiguous
//                         VMEM slices; a per-pixel 16-byte gather needs none, so
//                         the A row of output (oy, ox) and tap (dy, dx) is read
//                         at input (2oy + dy - pad, 2ox + dx - pad).
//
// Every form: bias add in fp32, optional SiLU in fp32, then (fused form) the
// skip add in fp32, one rounding to bf16 at the end -- the order of the TPU
// kernels.  Bias precision: the wrappers pass the bias in fp32.  K1 and K4
// receive it rounded to the model dtype as in the JAX package; so do K3 and
// K5, because the port stores parameters in bf16 as the JAX package's editor
// does (param_dtype = dtype), and K5's per-batch bias is bias + time
// embedding summed in fp32.
//
// What bounds them on an H100: operations.  The main path's convs do
// 2*M*Cout*taps*Cin FLOPs on M output pixels; at these shapes that is 150-300
// FLOPs per byte moved, at or above the card's bf16 ridge point (~295
// FLOP/byte), so the tensor cores, not HBM, are the limit.
//
// Design: GEMM view  out[m, n] = sum_k A[m, k] * Wt[n, k]  with
//   m = output pixel (b, y, x), n = output channel, k = (tap, cin).
// A is never materialised: each K step (one tap, 64 input channels) loads the
// shifted input rows straight from the NHWC tensor with 16-byte cp.async
// copies; pixels that fall into the zero padding ring, channels past Cin and
// rows past M are zero-filled by the copy itself (src-size 0), so ragged Cin
// and the image border need no padded copy in HBM.  The weight is read in
// OHWI order (torch's OIHW in channels_last memory; the up2 phase weights as
// [phase, tap, Cout, Cin]) so both operands are K-contiguous, the layout
// mma.sync's row.col form wants.  Tiles are 128 pixels x 128 output channels
// x 64 k in a 3-stage cp.async ring in dynamic shared memory (two tiles in
// flight while one is multiplied); 8 warps each own a 64x32 sub-tile and read
// their fragments with ldmatrix.  The k loop walks (tap, channel chunk)
// incrementally, so a stage's copies cost no integer division.
//
// The fused prologue: once a stage's tile has landed, each thread maps the
// 16-byte vectors it copied itself through silu(x * scale + shift) in fp32
// and rounds them to bf16, before the barrier that hands the tile to the
// MMAs.  Vectors that were zero-filled (padding ring, channels past Cin, rows
// past M) are left alone: silu(0 * s + t) is not 0, and SAME semantics need
// the ring to stay zero after the normalisation.
//
// The epilogue works on the accumulator registers directly and masks ragged
// Cout (320, 8, 4, 3) per element.  wgmma/TMA would go further; that is
// later work.

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

enum Mode : int { kPlain = 0, kFused = 1, kUp2 = 2, kDown2 = 3 };

struct ConvArgs {
  const __nv_bfloat16* x;     // [B, H, W, Cin]
  const __nv_bfloat16* w;     // kUp2: [4 phases, 4 taps, Cout, Cin]; else [Cout, 9, Cin]
  const float* bias;          // [bias_rows, Cout] or null
  const float* scale;         // kFused: [B, Cin], or null for no prologue
  const float* shift;         // kFused: [B, Cin]
  const __nv_bfloat16* skip;  // kFused: [B, Ho, Wo, Cout] or null
  __nv_bfloat16* out;         // kUp2: [B, 2H, 2W, Cout]; else [B, Ho, Wo, Cout]
  int B, H, W, Cin, Cout;
  int Ho, Wo;                 // the GEMM's pixel grid (kUp2: one phase's)
  int silu, bias_rows, pad;
};

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

// x * sigmoid(x).  __fdividef: the IEEE division's slow path (taken for a
// zero numerator, for one) made the prologue 1.8x slower on all-zero data.
__device__ __forceinline__ float silu_f(float t) { return __fdividef(t, 1.f + __expf(-t)); }

// The prologue's scale and shift of 8 channels (c .. c+7) of batch item b.
struct Pre8 {
  float4 s[2], t[2];
};
__device__ __forceinline__ Pre8 load_pre8(const float* scale, const float* shift, long long off) {
  Pre8 r;
  r.s[0] = reinterpret_cast<const float4*>(scale + off)[0];
  r.s[1] = reinterpret_cast<const float4*>(scale + off)[1];
  r.t[0] = reinterpret_cast<const float4*>(shift + off)[0];
  r.t[1] = reinterpret_cast<const float4*>(shift + off)[1];
  return r;
}

// silu(x * s + t) on one 16-byte vector of 8 bf16 channels, in place.
__device__ __forceinline__ void prologue8(__nv_bfloat16* v, const Pre8& pre) {
  uint4 raw = *reinterpret_cast<const uint4*>(v);
  const float s[8] = {pre.s[0].x, pre.s[0].y, pre.s[0].z, pre.s[0].w,
                      pre.s[1].x, pre.s[1].y, pre.s[1].z, pre.s[1].w};
  const float t[8] = {pre.t[0].x, pre.t[0].y, pre.t[0].z, pre.t[0].w,
                      pre.t[1].x, pre.t[1].y, pre.t[1].z, pre.t[1].w};
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    h[e] = __floats2bfloat162_rn(silu_f(f.x * s[2 * e] + t[2 * e]),
                                 silu_f(f.y * s[2 * e + 1] + t[2 * e + 1]));
  }
  *reinterpret_cast<uint4*>(v) = raw;
}

template <int MODE>
__device__ __forceinline__ void conv_body(const ConvArgs& p) {
  constexpr int KW = MODE == kUp2 ? 2 : 3;  // taps per row
  constexpr int NTAP = KW * KW;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // Stage s holds A (BM rows) then B (BN rows), each row LDS wide.
  auto a_tile = [&](int s) { return smem + s * STAGE_ELEMS; };
  auto b_tile = [&](int s) { return smem + s * STAGE_ELEMS + BM * LDS; };

  const int H = p.H, W = p.W, Cin = p.Cin, Cout = p.Cout;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // 0..1
  const int wn = warp & 3;   // 0..3
  const int g = lane >> 2;   // mma group id
  const int tg = lane & 3;   // thread in group

  const long long HWo = (long long)p.Ho * p.Wo;
  const long long M = (long long)p.B * HWo;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int phase = MODE == kUp2 ? (int)blockIdx.z : 0;  // 2p + q
  const __nv_bfloat16* w = p.w + (MODE == kUp2 ? (long long)phase * NTAP * Cout * Cin : 0);

  // Each thread copies RPT 16-byte vectors of A and of B per stage: rows
  // (tid / VPR) + (256 / VPR) * i, vector (tid % VPR) of the 64-wide k.
  // ay, ax: input pixel read by tap (0, 0); apix: pixel index of (b, 0, 0)
  // in the input, -1 past M; ab: batch index.
  const int vec = tid % VPR;
  const int row0 = tid / VPR;
  constexpr int ROW_STEP = NTHREADS / VPR;
  int ay[RPT], ax[RPT], apix[RPT], ab[RPT];
  for (int i = 0; i < RPT; ++i) {
    const long long m = m0 + row0 + ROW_STEP * i;
    const long long mm = m < M ? m : 0;
    const int b = (int)(mm / HWo);
    const int r = (int)(mm - (long long)b * HWo);
    const int oy = r / p.Wo, ox = r - (r / p.Wo) * p.Wo;
    if (MODE == kDown2) {
      ay[i] = 2 * oy - p.pad;
      ax[i] = 2 * ox - p.pad;
    } else if (MODE == kUp2) {
      ay[i] = oy + (phase >> 1) - 1;
      ax[i] = ox + (phase & 1) - 1;
    } else {
      ay[i] = oy - 1;
      ax[i] = ox - 1;
    }
    apix[i] = m < M ? b * H * W : -1;
    ab[i] = b;
  }
  auto a_ok = [&](int i, int tap, int c, int& yy, int& xx) {
    yy = ay[i] + tap / KW;
    xx = ax[i] + tap % KW;
    return apix[i] >= 0 && c < Cin && yy >= 0 && yy < H && xx >= 0 && xx < W;
  };

  const int ck = (Cin + BK - 1) / BK;  // k chunks per tap
  const int KT = NTAP * ck;

  // The next k tile to copy, as (tap, first channel); copies run in k order.
  int ld_tap = 0, ld_c = 0;
  auto load_stage = [&](int stage) {
    const int c = ld_c + vec * 8;
    const bool cin_ok = c < Cin;
    __nv_bfloat16* as = a_tile(stage);
    __nv_bfloat16* bs = b_tile(stage);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      int yy, xx;
      const bool ok = a_ok(i, ld_tap, c, yy, xx);
      const __nv_bfloat16* src =
          ok ? p.x + (((long long)apix[i] + yy * W + xx) * Cin + c) : p.x;
      cp_async16(as + (row0 + ROW_STEP * i) * LDS + vec * 8, src, ok);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int n = n0 + row0 + ROW_STEP * i;
      const bool ok = n < Cout && cin_ok;
      const long long off = MODE == kUp2 ? ((long long)ld_tap * Cout + n) * Cin + c
                                         : ((long long)n * 9 + ld_tap) * Cin + c;
      cp_async16(bs + (row0 + ROW_STEP * i) * LDS + vec * 8, ok ? w + off : w, ok);
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
  const bool prenorm = MODE == kFused && p.scale != nullptr;
  int pr_tap = 0, pr_c = 0;  // (tap, first channel) of tile kt, for the prologue
  // Scale and shift of this thread's channels in the next tile to transform,
  // for batch item ab[0], loaded a tile ahead so that their latency hides
  // behind the MMAs; a row of another batch item loads its own.
  Pre8 pre{};
  if (prenorm && vec * 8 < Cin) pre = load_pre8(p.scale, p.shift, (long long)ab[0] * Cin + vec * 8);

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    if (prenorm) {  // this thread's own copies of tile kt have landed
      const int c = pr_c + vec * 8;
      __nv_bfloat16* as = a_tile(kt % STAGES);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        int yy, xx;
        if (a_ok(i, pr_tap, c, yy, xx)) {
          __nv_bfloat16* v = as + (row0 + ROW_STEP * i) * LDS + vec * 8;
          if (ab[i] == ab[0])
            prologue8(v, pre);
          else
            prologue8(v, load_pre8(p.scale, p.shift, (long long)ab[i] * Cin + c));
        }
      }
      pr_c += BK;
      if (pr_c >= Cin) {
        pr_c = 0;
        ++pr_tap;
      }
      const int cn = pr_c + vec * 8;
      if (kt + 1 < KT && cn < Cin)
        pre = load_pre8(p.scale, p.shift, (long long)ab[0] * Cin + cn);
    }
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
      long long opix = m;
      const float* brow = p.bias;
      const __nv_bfloat16* srow = nullptr;
      if (MODE == kUp2) {
        const long long b = m / HWo;
        const int r = (int)(m - b * HWo);
        const int oy = r / p.Wo, ox = r - (r / p.Wo) * p.Wo;
        opix = (b * 2 * p.Ho + 2 * oy + (phase >> 1)) * (2LL * p.Wo) + 2 * ox + (phase & 1);
      }
      if (MODE == kFused) {
        if (brow != nullptr && p.bias_rows > 1) brow += (m / HWo) * Cout;
        if (p.skip != nullptr) srow = p.skip + m * Cout;
      }
      __nv_bfloat16* orow = p.out + opix * Cout;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + wn * WN + j * 8 + tg * 2;
        float v[2];
        for (int e = 0; e < 2; ++e) {
          float t = acc[i][j][half * 2 + e];
          if (brow != nullptr && n + e < Cout) t += brow[n + e];
          if (p.silu) t = silu_f(t);
          if (MODE == kFused && srow != nullptr && n + e < Cout)
            t += __bfloat162float(srow[n + e]);
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

__global__ void __launch_bounds__(NTHREADS, 2) conv3x3_kernel(const ConvArgs p) {
  conv_body<kPlain>(p);
}
__global__ void __launch_bounds__(NTHREADS, 2) conv3x3_fused_kernel(const ConvArgs p) {
  conv_body<kFused>(p);
}
__global__ void __launch_bounds__(NTHREADS, 2) conv3x3_up2_kernel(const ConvArgs p) {
  conv_body<kUp2>(p);
}
__global__ void __launch_bounds__(NTHREADS, 2) conv3x3_down2_kernel(const ConvArgs p) {
  conv_body<kDown2>(p);
}

// Phase weights [4 phases (2p + q), 4 taps (2a + b), Cout, Cin] from OHWI w
// [Cout, 3, 3, Cin]: tap a of phase p sums the 3x3 rows ROWS[p][a] (a bit
// mask), tap b of phase q the columns ROWS[q][b]; fp32 sums of the bf16
// taps, rounded to bf16 once (make_phase_kernels in ops/conv_fused.py).
__global__ void up2_phase_weights_kernel(const __nv_bfloat16* __restrict__ w,
                                         __nv_bfloat16* __restrict__ wp, int Cout, int Cin) {
  constexpr int ROWS[2][2] = {{0b001, 0b110}, {0b011, 0b100}};
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = (long long)Cout * Cin;
  if (idx >= n) return;
  const long long o = idx / Cin, i = idx - o * Cin;
  float t[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) t[k] = __bfloat162float(w[(o * 9 + k) * Cin + i]);
#pragma unroll
  for (int ph = 0; ph < 4; ++ph)
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      const int rows = ROWS[ph >> 1][tap >> 1], cols = ROWS[ph & 1][tap & 1];
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < 3; ++d)
#pragma unroll
        for (int e = 0; e < 3; ++e)
          if ((rows >> d & 1) && (cols >> e & 1)) s += t[d * 3 + e];
      wp[(ph * 4 + tap) * n + idx] = __float2bfloat16(s);
    }
}

// Raise the kernel's dynamic shared memory limit once, then launch over the
// GEMM's (pixel tile, channel tile[, phase]) grid.
int launch(void (*kernel)(const ConvArgs), bool& configured, const ConvArgs& a, int phases,
           void* stream) {
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const long long M = (long long)a.B * a.Ho * a.Wo;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((a.Cout + BN - 1) / BN), phases);
  kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

ConvArgs args(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
              int Cin, int Cout, int silu) {
  ConvArgs a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B, a.H = H, a.W = W, a.Cin = Cin, a.Cout = Cout;
  a.Ho = H, a.Wo = W, a.silu = silu, a.bias_rows = 1;
  return a;
}

}  // namespace

// x [B, H, W, Cin], w [Cout, 3, 3, Cin], bias [Cout] fp32 or null -> out [B, H, W, Cout].
extern "C" int conv3x3_bf16(const void* x, const void* w, const void* bias, void* out,
                            int B, int H, int W, int Cin, int Cout, int silu,
                            void* stream) {
  static bool configured = false;
  return launch(conv3x3_kernel, configured, args(x, w, bias, out, B, H, W, Cin, Cout, silu), 1,
                stream);
}

// As conv3x3_bf16, plus: bias [bias_rows, Cout] fp32 (bias_rows 1 or B);
// scale, shift [B, Cin] fp32 for the prologue, or both null; skip
// [B, H, W, Cout] bf16 or null.
extern "C" int conv3x3_fused_bf16(const void* x, const void* w, const void* bias,
                                  const void* scale, const void* shift, const void* skip,
                                  void* out, int B, int H, int W, int Cin, int Cout, int silu,
                                  int bias_rows, void* stream) {
  static bool configured = false;
  ConvArgs a = args(x, w, bias, out, B, H, W, Cin, Cout, silu);
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.skip = static_cast<const __nv_bfloat16*>(skip);
  a.bias_rows = bias_rows;
  return launch(conv3x3_fused_kernel, configured, a, 1, stream);
}

// x [B, H, W, Cin], w [Cout, 3, 3, Cin] -> out [B, 2H, 2W, Cout]; wp4
// receives the phase weights [2, 2, 2, 2, Cout, Cin] (p, q, a, b).
extern "C" int conv3x3_up2_bf16(const void* x, const void* w, void* wp4, const void* bias,
                                void* out, int B, int H, int W, int Cin, int Cout, int silu,
                                void* stream) {
  static bool configured = false;
  const long long n = (long long)Cout * Cin;
  up2_phase_weights_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(wp4), Cout, Cin);
  return launch(conv3x3_up2_kernel, configured,
                args(x, wp4, bias, out, B, H, W, Cin, Cout, silu), 4, stream);
}

// x [B, H, W, Cin] (H, W even), w [Cout, 3, 3, Cin]; pad 1: padding (1, 1),
// pad 0: (0, 1) -> out [B, H/2, W/2, Cout].
extern "C" int conv3x3_down2_bf16(const void* x, const void* w, const void* bias, void* out,
                                  int B, int H, int W, int Cin, int Cout, int silu, int pad,
                                  void* stream) {
  static bool configured = false;
  ConvArgs a = args(x, w, bias, out, B, H, W, Cin, Cout, silu);
  a.Ho = H / 2, a.Wo = W / 2, a.pad = pad;
  return launch(conv3x3_down2_kernel, configured, a, 1, stream);
}
