// 3x3 convolutions, NHWC fp32, as register-tiled SIMT implicit GEMMs: fp32
// operands, fp32 multiplies (FFMA, not TF32) and fp32 accumulation.  The
// fp32 instances of two of the four TPU kernels that conv3x3.cu ports in
// bf16, one kernel template (conv_f32_kernel<MODE, TN>) with two modes (the
// other two, the stride-1 and the stride-2 conv, run on the tensor cores in
// 3xTF32: conv3x3_tf32x3.cu):
//
//   FUSED  3x3 SAME stride 1 with the resnet block's ops folded in; replaces
//          fastedit_tpu/ops/conv_fused.py `conv3x3_fused` (`_fused_call`): a
//          prologue silu(x * scale[b, c] + shift[b, c]) applied to every
//          staged in-image input element (the padding ring stays zero, as
//          the TPU kernel re-zeroes it), a per-batch bias [B, Cout] and a
//          skip add after the bias and SiLU.
//   UP2    nearest-2x upsample then 3x3 SAME conv as four 2x2 phase convs of
//          the low-res input; replaces `conv3x3_up2` (`_up2_call`).  The
//          phase weights [Cout, 2, 2, 2, 2, Cin] (p, q, a, b) are folded in
//          fp32 outside (ops/conv_fused.fold_up2, once per weight); tap (a,
//          b) of phase (p, q) reads low-res pixel (i - 1 + a + p, j - 1 + b
//          + q).  A phase is a coordinate of the tile.
//
// Epilogue of every mode, in fp32 and in the TPU kernels' order: bias, SiLU
// (optional), skip add (FUSED).  The output is fp32.
//
// GEMM view: out[m, n] = sum_k A[m, k] Wt[n, k], m = output pixel, n = output
// channel, k = (tap, cin).  A block (256 threads) computes a tile of RH x RW
// = 8 x 16 output pixels (low-res pixels for UP2, one phase) times BN output
// channels.  Per chunk of KC = 8 input channels it stages, with cp.async
// (zero fill outside the image and past Cout) into one of two buffers:
//   * the input window the tile's taps read, pixel-major [row][col][KC]:
//     10 x 18 pixels, the rectangle's stride-1 halo;
//   * the weights of those channels, [KC][taps][BN], read from torch's OIHW
//     in channels_last memory (OHWI) or the folded phase weights.
// while the other buffer is multiplied.  Each thread owns 8 pixels of one
// row of the tile (ty) times TN = BN / 16 channels (tx) in registers: per
// (channel, tap row) it reads the row's 10 window values once
// and serves its three taps from registers, and per tap one or two 16-byte
// weight loads; 64 FFMAs per 4 shared-memory loads at TN = 8.  A warp's two
// pixel groups lie in two rows of the window, so their loads hit different
// banks.  The schedule (BN, tiles, grid, shared memory) comes from
// ops/conv3x3.plan_f32, which ops/conv3x3.conv_tiled_plain_f32 and
// ops/conv_fused.*_tiled_plain_f32 walk in PyTorch for the tests.
//
// What bounds it on an H100 SXM: operations.  2 * M * Cout * taps * Cin
// FLOPs at 67 TFLOP/s (fp32 outside the tensor cores, NVIDIA's data sheet)
// against the bytes of x, the weights and the output at 3.35 TB/s: the main
// path's convs do 50-200 FLOPs per fp32 byte, above the fp32 ridge point
// (~20 FLOP/byte), so the FFMA rate is the limit.  The design keeps the
// FFMA pipes fed from registers (each window value serves three taps and
// eight channels, each weight eight pixels) and hides the chunk loads
// behind the previous chunk's FFMAs.  It does not reach the bound: the
// tensor cores (3xTF32 on wgmma) are the way there, queued in ROADMAP.md.

#include "simt_f32.cuh"

namespace {

using namespace simt;

constexpr int THREADS = 256;
constexpr int RH = 8, RW = 16;  // output pixels of a tile (low-res pixels for UP2)
constexpr int KC = 8;           // input channels per staged chunk
constexpr int STAGES = 2;

enum Mode { FUSED = 1, UP2 = 3 };  // 0 and 2 were the stride-1 and stride-2 convs

template <int MODE>
struct Geo {
  static constexpr int WR = RH + 2;  // window rows
  static constexpr int WC = RW + 2;  // window columns
  static constexpr int TAPS = MODE == UP2 ? 4 : 9;                // taps of a tile
  static constexpr int WTAPS = MODE == UP2 ? 16 : 9;              // taps of a weight row
  static constexpr int WIN = WR * WC * KC;                        // floats of a window
};

template <int MODE, int BN>
__host__ __device__ constexpr int stage_floats() {
  return Geo<MODE>::WIN + KC * Geo<MODE>::TAPS * BN;
}

template <int MODE, int BN>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * stage_floats<MODE, BN>() * 4;
}

struct Args {
  const float* x;
  const float* w;
  const float* bias;   // [bias_rows, Cout] or null
  const float* scale;  // FUSED: [B, Cin] or null (no prologue)
  const float* shift;
  const float* skip;  // FUSED: [B, H, W, Cout] or null
  float* out;
  int B, H, W, Cin, Cout, silu, bias_rows;
  int tiles_y, tiles_x, tiles_n;
};

// Channel of accumulator column n of thread tx within the tile.
template <int TN>
__device__ __forceinline__ int channel(int tx, int n) {
  if constexpr (TN == 8) return n < 4 ? tx * 4 + n : 64 + tx * 4 + n - 4;
  if constexpr (TN == 4) return tx * 4 + n;
  return tx;
}

template <int TN>
__device__ __forceinline__ void load_w(const float* row, int tx, float* wv) {
  if constexpr (TN == 8) {
    const float4 a = *reinterpret_cast<const float4*>(row + tx * 4);
    const float4 b = *reinterpret_cast<const float4*>(row + 64 + tx * 4);
    wv[0] = a.x, wv[1] = a.y, wv[2] = a.z, wv[3] = a.w;
    wv[4] = b.x, wv[5] = b.y, wv[6] = b.z, wv[7] = b.w;
  } else if constexpr (TN == 4) {
    const float4 a = *reinterpret_cast<const float4*>(row + tx * 4);
    wv[0] = a.x, wv[1] = a.y, wv[2] = a.z, wv[3] = a.w;
  } else {
    wv[0] = row[tx];
  }
}

// Two blocks per SM, but one for the 128-channel tile: under two blocks'
// 128-register cap its 64 accumulators spill a few bytes (ptxas), and one
// block per SM measured within 1-9% of the spilling build
// (tools/variants_conv_f32.py).
template <int MODE, int TN>
__global__ void __launch_bounds__(THREADS, TN == 8 ? 1 : 2) conv_f32_kernel(const Args a) {
  using G = Geo<MODE>;
  constexpr int BN = 16 * TN;
  constexpr int STAGE = stage_floats<MODE, BN>();
  extern __shared__ __align__(16) float smem[];

  // The tile: channel tile fastest, then the phase (UP2), the rectangle's
  // column, its row, the image.
  int t = blockIdx.x;
  const int tn = t % a.tiles_n;
  t /= a.tiles_n;
  int phase = 0;
  if constexpr (MODE == UP2) {
    phase = t & 3;
    t >>= 2;
  }
  const int rx = t % a.tiles_x;
  t /= a.tiles_x;
  const int ry = t % a.tiles_y;
  const int b = t / a.tiles_y;
  const int y0 = ry * RH, x0 = rx * RW, n0 = tn * BN;
  const int pp = phase >> 1, pq = phase & 1;
  // the window's first input row and column
  const int oy = y0 - 1, ox = x0 - 1;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r = ty & 7, cb = (ty >> 3) * 8;  // the thread's 8 pixels: row r, columns cb..cb+7

  const float* xb = a.x + (long long)b * a.H * a.W * a.Cin;
  auto issue = [&](int k, int s) {
    float* win = smem + s * STAGE;
    float* ws = win + G::WIN;
    const int c0 = k * KC;
    for (int i = tid; i < G::WR * G::WC * 2; i += THREADS) {
      const int p = i >> 1, q = i & 1, wr = p / G::WC, wc = p - wr * G::WC;
      const int iy = oy + wr, ix = ox + wc;
      const bool in = iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
      const float* src = in ? xb + ((long long)iy * a.W + ix) * a.Cin + c0 + 4 * q : a.x;
      cp_async16(win + p * KC + 4 * q, src, in);
    }
    // weights: n fastest (neighbouring threads, neighbouring shared words),
    // then the channel, then the tap
    for (int e = tid; e < KC * G::TAPS * BN; e += THREADS) {
      const int n = e % BN, rest = e / BN, c = rest % KC, tap = rest / KC;
      const bool in = n0 + n < a.Cout;
      const int wtap = MODE == UP2 ? 4 * phase + tap : tap;
      const float* src = in ? a.w + ((long long)(n0 + n) * G::WTAPS + wtap) * a.Cin + c0 + c : a.w;
      cp_async4(ws + (c * G::TAPS + tap) * BN + n, src, in);
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[j][n] = 0.f;

  const int nk = a.Cin / KC;
  issue(0, 0);
  cp_async_commit();
  for (int k = 0; k < nk; ++k) {
    if (k + 1 < nk) {
      issue(k + 1, (k + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* win = smem + (k & 1) * STAGE;
    const float* ws = win + G::WIN;
    if constexpr (MODE == FUSED) {
      if (a.scale != nullptr) {  // the prologue, on in-image elements only
        const int c0 = k * KC;
        for (int i = tid; i < G::WR * G::WC * 2; i += THREADS) {
          const int p = i >> 1, q = i & 1, wr = p / G::WC, wc = p - wr * G::WC;
          const int iy = oy + wr, ix = ox + wc;
          if (iy < 0 || iy >= a.H || ix < 0 || ix >= a.W) continue;
          float4* v = reinterpret_cast<float4*>(win + p * KC + 4 * q);
          const float4 sc = *reinterpret_cast<const float4*>(a.scale + b * a.Cin + c0 + 4 * q);
          const float4 sh = *reinterpret_cast<const float4*>(a.shift + b * a.Cin + c0 + 4 * q);
          float4 u = *v;
          u.x = silu(fmaf(u.x, sc.x, sh.x));
          u.y = silu(fmaf(u.y, sc.y, sh.y));
          u.z = silu(fmaf(u.z, sc.z, sh.z));
          u.w = silu(fmaf(u.w, sc.w, sh.w));
          *v = u;
        }
        __syncthreads();
      }
    }
#pragma unroll 1
    for (int c = 0; c < KC; ++c) {
      if constexpr (MODE == UP2) {
#pragma unroll
        for (int ta = 0; ta < 2; ++ta) {
          const float* row = win + ((r + ta + pp) * G::WC + cb + pq) * KC + c;
          float v[9];
#pragma unroll
          for (int i = 0; i < 9; ++i) v[i] = row[i * KC];
#pragma unroll
          for (int tb = 0; tb < 2; ++tb) {
            float wv[TN];
            load_w<TN>(ws + (c * G::TAPS + 2 * ta + tb) * BN, tx, wv);
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int n = 0; n < TN; ++n) acc[j][n] = fmaf(v[j + tb], wv[n], acc[j][n]);
          }
        }
      } else {
        constexpr int NV = 10;  // the row's window values the thread's 8 pixels read
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float* row = win + ((r + dy) * G::WC + cb) * KC + c;
          float v[NV];
#pragma unroll
          for (int i = 0; i < NV; ++i) v[i] = row[i * KC];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            float wv[TN];
            load_w<TN>(ws + (c * G::TAPS + dy * 3 + dx) * BN, tx, wv);
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int n = 0; n < TN; ++n) acc[j][n] = fmaf(v[j + dx], wv[n], acc[j][n]);
          }
        }
      }
    }
    __syncthreads();  // the buffer is read: the next chunk but one may land in it
  }

  // epilogue: bias, SiLU, skip, in fp32
  const int ho = MODE == UP2 ? 2 * a.H : a.H, wo = MODE == UP2 ? 2 * a.W : a.W;
  const int in_h = a.H, in_w = a.W;
  const float* bias = a.bias == nullptr ? nullptr
                                        : a.bias + (a.bias_rows > 1 ? (long long)b * a.Cout : 0);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int py = y0 + r, px = x0 + cb + j;
    if (py >= in_h || px >= in_w) continue;
    const int y = MODE == UP2 ? 2 * py + pp : py, x = MODE == UP2 ? 2 * px + pq : px;
    const long long pix = ((long long)b * ho + y) * wo + x;
    float* o = a.out + pix * a.Cout;
    const float* sk = MODE == FUSED && a.skip != nullptr ? a.skip + pix * a.Cout : nullptr;
    auto finish = [&](float v, int n) {
      if (bias != nullptr) v += bias[n];
      if (a.silu) v = silu(v);
      if (sk != nullptr) v += sk[n];
      return v;
    };
    if constexpr (TN >= 4) {
#pragma unroll
      for (int g = 0; g < TN; g += 4) {  // runs of 4 channels
        const int n = n0 + channel<TN>(tx, g);
        if (a.Cout % 4 == 0) {
          if (n < a.Cout)
            *reinterpret_cast<float4*>(o + n) =
                make_float4(finish(acc[j][g], n), finish(acc[j][g + 1], n + 1),
                            finish(acc[j][g + 2], n + 2), finish(acc[j][g + 3], n + 3));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n + e < a.Cout) o[n + e] = finish(acc[j][g + e], n + e);
        }
      }
    } else {
      const int n = n0 + channel<TN>(tx, 0);
      if (n < a.Cout) o[n] = finish(acc[j][0], n);
    }
  }
}

template <int MODE, int TN>
int launch(Args a, int tiles, cudaStream_t stream) {
  static unsigned long long configured = 0;
  constexpr int bytes = smem_bytes<MODE, 16 * TN>();
  if (int err = allow_smem(conv_f32_kernel<MODE, TN>, bytes, configured)) return err;
  conv_f32_kernel<MODE, TN><<<tiles, THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The grid (one block per tile) and the launch of the instance with channel
// tile bn; 0 or a CUDA error.
template <int MODE>
int run(Args a, int bn, void* stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.out) |
                        reinterpret_cast<uintptr_t>(a.scale) |
                        reinterpret_cast<uintptr_t>(a.shift)) % 16 == 0;
  if (a.B < 1 || a.H < 1 || a.W < 1 || a.Cin < KC || a.Cin % KC || a.Cout < 1 || !aligned ||
      (bn != 16 && bn != 64 && bn != 128) ||
      (MODE == FUSED && (a.scale == nullptr) != (a.shift == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  a.tiles_y = (a.H + RH - 1) / RH;
  a.tiles_x = (a.W + RW - 1) / RW;
  a.tiles_n = (a.Cout + bn - 1) / bn;
  const long long tiles =
      (long long)a.B * a.tiles_y * a.tiles_x * a.tiles_n * (MODE == UP2 ? 4 : 1);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 128: return launch<MODE, 8>(a, (int)tiles, s);
    case 64: return launch<MODE, 4>(a, (int)tiles, s);
    default: return launch<MODE, 1>(a, (int)tiles, s);
  }
}

Args make_args(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
               int Cin, int Cout, int silu) {
  Args a{};
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.B = B, a.H = H, a.W = W, a.Cin = Cin, a.Cout = Cout, a.silu = silu, a.bias_rows = 1;
  return a;
}

}  // namespace

// Dynamic shared memory of the instance (mode 1 FUSED, 3 UP2; channel tile bn
// 16, 64 or 128), or -1.
extern "C" int conv3x3_f32_smem_bytes(int mode, int bn) {
  if (bn != 16 && bn != 64 && bn != 128) return -1;
  const int f = mode == UP2     ? Geo<UP2>::WIN + KC * 4 * bn
              : mode == FUSED ? Geo<FUSED>::WIN + KC * 9 * bn
                              : -1;
  return f < 0 ? -1 : STAGES * f * 4;
}

// x [B, H, W, Cin] fp32, w [Cout, 3, 3, Cin] fp32 (OIHW in channels_last
// memory), bias [bias_rows, Cout] fp32 or null (bias_rows 1 or B) -> out [B, H,
// W, Cout] fp32; scale, shift [B, Cin] for the prologue, or both null; skip
// [B, H, W, Cout] or null; bn from the plan (ops/conv3x3.plan_f32).
extern "C" int conv3x3_fused_f32(const void* x, const void* w, const void* bias,
                                 const void* scale, const void* shift, const void* skip,
                                 void* out, int B, int H, int W, int Cin, int Cout, int silu,
                                 int bias_rows, int bn, void* stream) {
  Args a = make_args(x, w, bias, out, B, H, W, Cin, Cout, silu);
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.skip = static_cast<const float*>(skip);
  a.bias_rows = bias_rows;
  if (bias_rows != 1 && bias_rows != B) return static_cast<int>(cudaErrorInvalidValue);
  return run<FUSED>(a, bn, stream);
}

// x [B, H, W, Cin] -> out [B, 2H, 2W, Cout] through the fp32 phase weights wp
// [Cout, 2, 2, 2, 2, Cin] (ops/conv_fused.fold_up2).
extern "C" int conv3x3_up2_f32(const void* x, const void* wp, const void* bias, void* out,
                               int B, int H, int W, int Cin, int Cout, int silu, int bn,
                               void* stream) {
  return run<UP2>(make_args(x, wp, bias, out, B, H, W, Cin, Cout, silu), bn, stream);
}
