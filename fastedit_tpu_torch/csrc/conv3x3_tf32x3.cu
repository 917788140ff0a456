// 3x3 convs, NHWC fp32, on the tensor cores in 3xTF32: the fp32 instances of
// fastedit_tpu/ops/conv3x3.py `conv3x3` (`_conv3x3_call`: SAME, stride 1)
// and of fastedit_tpu/ops/conv_fused.py `conv3x3_down2` (`_down2_call` /
// `_down2_kernel`: stride 2, padding (1, 1) for the UNet's, ControlNet's and
// the conditioning tower's downsamplers or (0, 1) for the VAE encoder's);
// bias and optional SiLU in fp32, fp32 out.  conv3x3.cu holds the bf16
// instances of the same design, one template for both strides; here too one
// core (conv_tiles<BN, DOWN2>) serves conv3x3_tf32x3_kernel<BN> (stride 1) and
// conv3x3_down2_tf32x3_kernel<BN> (stride 2):
//
//   * A stage holds the input pixels a tile of 8 x 16 output pixels reads,
//     for 32 input channels (one 128-byte swizzle row a pixel), landed by TMA
//     with zero fill for the padding, pixels past the image and channels past
//     Cin.  Stride 1: the tile's halo, (8 + 2) x (16 + 2) pixels, 23 KB, one
//     load; three stages.  Stride 2: the windows of the input's four parity
//     planes (odd or even rows x odd or even columns), each a tensor map over
//     [B, H/2, W/2, Cin] read at twice the strides, so that each of the nine
//     taps is a rectangle shift of one plane's window: with padding p, tap k
//     of an axis reads the plane of parity (k + p) & 1 at output coordinate +
//     floor((k - p) / 2); (9 + 8) x (17 + 16) pixels, 70 KB, four loads; two
//     stages.
//   * The weights, OIHW in channels_last memory ([Cout, 9, Cin], K-major as
//     wgmma at .tf32 needs), split once per weight into hi and lo TF32 copies
//     (split_tf32_kernel; ops/conv_fused.split_tf32, cached by the conv
//     modules per weight version).  A weight stage is one tap's hi and lo for
//     BN output channels and 32 input channels, by two TMA loads; as many
//     stages as fit beside the input's (stride 1: seven or eight, stride 2:
//     four).
//   * The activations are split on the way in: a consumer thread reads its
//     A fragment of a tap (two pixels x 4 channels a k step) from the
//     swizzled stage, splits each value into hi and lo in registers, and
//     issues three wgmmas a k step with A from registers (m64nBNk8: x_lo
//     w_hi, x_hi w_lo, x_hi w_hi).  A pixel's row of the stage is found as
//     the TMA swizzle wrote it: 16-byte chunk c of stage pixel i at chunk
//     c ^ (i & 7), each window on a 1024-byte boundary.
//   * Warp-specialised and persistent: warp 8 is the producer (one thread
//     keeps both rings full through "full" mbarriers); warps 0-7 are two
//     consumer warpgroups, each 64 output pixels (output rows 2w and 2w + 1
//     of warp w, columns 8wg .. 8wg + 7) x BN channels, fp32 accumulators in
//     registers; a warpgroup waits for each tap's wgmmas before it loads the
//     next tap's fragments into the same registers (and before it adds the
//     fresh accumulators in, below), and the other warpgroup keeps the
//     tensor cores busy meanwhile.  Each block walks tiles
//     blockIdx.x, + gridDim.x, ..., channel tile fastest.
//   * Channel tiles (ops/conv3x3.plan and plan_down2 at item size 4): the
//     tile's accumulators and the fresh ones of a tap (2 x BN / 2 registers)
//     and a tap's fragments (32) fit the 168 registers a thread of a
//     288-thread block gets (ptxas budgets whole warpgroups); 160 spilled.
//     Stride 2: 80 where it divides Cout, else 64.  Stride 1: 8 for the Cout
//     <= 8 tails (zero-filled past Cout), else whichever of 80, 64 and 48
//     wastes the fewest columns (320, 640, 1280: 80; 96: 48).  Cin not a
//     multiple of 32: the last chunk's channels past Cin are zero-filled in
//     both operands and add nothing.
//
// What bounds it on an H100 SXM: operations.  3 x 2 * M * Cout * 9 * Cin
// TF32 FLOPs at 494.7 TFLOP/s against x, both weight copies and the output
// at 3.35 TB/s.  Inside the card the weights' traffic from L2 is the nearer
// limit: every tile of 128 pixels streams the hi and lo weights of its
// channels (8 bytes a weight, 96 TF32 FLOPs a byte: 5.2 TB/s at the tensor
// cores' rate).  No sum is split between blocks: two launches give the same
// bits.

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int RECT_H = 8, RECT_W = 16;  // output pixels of a tile
constexpr int KC = 32;                  // input channels of a chunk: 128 bytes
constexpr int PIXEL = KC * 4;           // bytes of a pixel's chunk: one swizzle row
constexpr int HALO_H = RECT_H + 2, HALO_W = RECT_W + 2;  // stride 1
constexpr int PLANE_H = RECT_H + 1, PLANE_W = RECT_W + 1;  // stride 2
__host__ __device__ constexpr int round_1024(int n) { return (n + 1023) / 1024 * 1024; }
// Planes in the order big/big, big/small, small/big, small/small (rows /
// columns): a plane whose parity equals the padding serves taps 0 and 2 of
// its axis and is one pixel longer along it.
__host__ __device__ constexpr int plane_h(int pl) { return pl < 2 ? PLANE_H : RECT_H; }
__host__ __device__ constexpr int plane_w(int pl) { return pl % 2 == 0 ? PLANE_W : RECT_W; }
__host__ __device__ constexpr int plane_offset(int pl) {
  return pl == 0 ? 0 : plane_offset(pl - 1) + round_1024(plane_h(pl - 1) * plane_w(pl - 1) * PIXEL);
}
// An input stage: its bytes in shared memory, the bytes its loads land, the
// ring's depth and the most weight stages beside it.
__host__ __device__ constexpr int a_stage(bool down2) {
  return down2 ? plane_offset(3) + round_1024(plane_h(3) * plane_w(3) * PIXEL)
               : round_1024(HALO_H * HALO_W * PIXEL);
}
__host__ __device__ constexpr int a_bytes(bool down2) {
  return down2 ? (PLANE_H + RECT_H) * (PLANE_W + RECT_W) * PIXEL : HALO_H * HALO_W * PIXEL;
}
__host__ __device__ constexpr int a_stages(bool down2) { return down2 ? 2 : 3; }
__host__ __device__ constexpr int max_w_stages(bool down2) { return down2 ? 4 : 8; }
constexpr int THREADS = 288;  // two consumer warpgroups and a producer warp
constexpr int SMEM_LIMIT = 232448;
// Where the products of a tap are summed.  The tensor cores add into their
// fp32 accumulators with truncation (round toward zero), an error of up to an
// ulp of the sum at every wgmma, all of one sign; summed there over a whole
// tile, the fp64 gate read 5-15x the plain fp32 conv's error
// (tools/variants_conv_tf32x3.py).  So a tap's products go into a fresh
// accumulator, the two small products first (while it is small) and then the
// x_hi w_hi ones, which is added into the tile's accumulators with an fp32 add
// that rounds to nearest: 0.2-0.3x the plain conv's error.
__host__ __device__ constexpr int w_half(int bn) { return bn * PIXEL; }  // hi or lo of a tap
__host__ __device__ constexpr int bar_bytes(bool down2, int sb) {
  return 8 * (2 * a_stages(down2) + 2 * sb);
}
// Weight stages: as many as fit beside the input stages, at most max_w_stages.
__host__ __device__ constexpr int w_room(bool down2) {
  return SMEM_LIMIT - 1024 - a_stages(down2) * a_stage(down2) -
         bar_bytes(down2, max_w_stages(down2));
}
__host__ __device__ constexpr int w_stages(bool down2, int bn) {
  return w_room(down2) / (2 * w_half(bn)) < max_w_stages(down2) ? w_room(down2) / (2 * w_half(bn))
                                                                : max_w_stages(down2);
}
__host__ __device__ constexpr int smem_bytes(bool down2, int bn) {
  return 1024 + a_stages(down2) * a_stage(down2) + w_stages(down2, bn) * 2 * w_half(bn) +
         bar_bytes(down2, w_stages(down2, bn));
}

struct Args {
  const float* bias;  // [Cout] or null
  float* out;         // [B, H, W, Cout]
  int B, H, W, Cin, Cout;  // H, W: the output's
  int silu, pad;           // stride 2: padding before the first row and column, 1 or 0
  int tiles_x, tiles_y, tiles_n, tiles;
};

struct XMaps {
  CUtensorMap m[4];  // stride 1: the input, m[0]; stride 2: parity plane (py, px) at 2 py + px
};

// The tiles of one block: both strides (the kernels below are this, inlined).
template <int BN, bool DOWN2>
__device__ __forceinline__ void conv_tiles(const XMaps& maps_x, const CUtensorMap& map_w_hi,
                                           const CUtensorMap& map_w_lo, const Args& p) {
  constexpr int SA = a_stages(DOWN2), A_STAGE = a_stage(DOWN2), A_BYTES = a_bytes(DOWN2);
  constexpr int SB = w_stages(DOWN2, BN), W_HALF = w_half(BN), W_STAGE = 2 * W_HALF;
  static_assert(BN % 8 == 0 && BN <= 256 && SB >= 2, "a channel tile that does not fit");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t a_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t b_smem = a_smem + SA * A_STAGE;
  const uint32_t bars = b_smem + SB * W_STAGE;
  auto full_a = [&](int s) { return bars + 8 * s; };
  auto empty_a = [&](int s) { return bars + 8 * (SA + s); };
  auto full_b = [&](int s) { return bars + 8 * (2 * SA + s); };
  auto empty_b = [&](int s) { return bars + 8 * (2 * SA + SB + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ck = (p.Cin + KC - 1) / KC;  // channel chunks
  if (threadIdx.x == 0) {
    for (int s = 0; s < SA; ++s) {
      mbar_init(full_a(s), 1);   // the producer's expect_tx
      mbar_init(empty_a(s), 8);  // lane 0 of every consumer warp
    }
    for (int s = 0; s < SB; ++s) {
      mbar_init(full_b(s), 1);
      mbar_init(empty_b(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tile t: the channel tile fastest, then the rectangle's column, its row, the image.
  auto tile_at = [&](int t, int& b, int& y0, int& x0, int& n0) {
    const int m = t / p.tiles_n;
    n0 = (t - m * p.tiles_n) * BN;
    const int row = m / p.tiles_x;
    x0 = (m - row * p.tiles_x) * RECT_W;
    b = row / p.tiles_y;
    y0 = (row - b * p.tiles_y) * RECT_H;
  };

  if (warp == 8) {
    if (lane != 0) return;
    // Producer.  The input stage of chunk i + SA - 1 takes the stage of chunk
    // i - 1, which the consumers free when chunk i - 1's last tap has
    // retired, so it is asked for after the weights of chunk i's first tap.
    int sa = 0, pa = 0, sb = 0, pb = 0;
    int at = blockIdx.x, ac = 0;  // (tile, chunk) of the next input stage
    auto load_window = [&]() {
      if (at >= p.tiles) return;
      int b, y0, x0, n0;
      tile_at(at, b, y0, x0, n0);
      mbar_wait(empty_a(sa), pa ^ 1);
      const uint32_t stage = a_smem + sa * A_STAGE;
      mbar_expect_tx(full_a(sa), A_BYTES);
      if constexpr (DOWN2) {
#pragma unroll
        for (int pl = 0; pl < 4; ++pl) {
          const int py = pl < 2 ? p.pad : 1 - p.pad, px = pl % 2 == 0 ? p.pad : 1 - p.pad;
          tma_load_4d(stage + plane_offset(pl), &maps_x.m[2 * py + px], full_a(sa), ac * KC,
                      x0 - (pl % 2 == 0 ? p.pad : 0), y0 - (pl < 2 ? p.pad : 0), b);
        }
      } else {
        tma_load_4d(stage, &maps_x.m[0], full_a(sa), ac * KC, x0 - 1, y0 - 1, b);
      }
      if (++sa == SA) sa = 0, pa ^= 1;
      if (++ac == ck) ac = 0, at += gridDim.x;
    };
    for (int i = 0; i < SA - 1; ++i) load_window();
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      int b, y0, x0, n0;
      tile_at(t, b, y0, x0, n0);
      for (int c = 0; c < ck; ++c) {
        for (int tap = 0; tap < 9; ++tap) {
          if (tap == 1) load_window();
          mbar_wait(empty_b(sb), pb ^ 1);
          const uint32_t stage = b_smem + sb * W_STAGE;
          mbar_expect_tx(full_b(sb), W_STAGE);
          tma_load_3d(stage, &map_w_hi, full_b(sb), c * KC, tap, n0);
          tma_load_3d(stage + W_HALF, &map_w_lo, full_b(sb), c * KC, tap, n0);
          if (++sb == SB) sb = 0, pb ^= 1;
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg, warp w of it.  wgmma row m is output pixel (row
  // m / 8, column 8 wg + m % 8) of the tile: thread (w, lane) holds rows 16w +
  // lane / 4 and + 8, output rows 2w and 2w + 1 at column 8 wg + lane / 4.
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, q = lane & 3;
  float acc[BN / 2], part[BN / 2];  // part: a tap's fresh accumulators
  int sa = 0, pa = 0, sb = 0, pb = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    int b, y0, x0, n0;
    tile_at(t, b, y0, x0, n0);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int c = 0; c < ck; ++c) {
      mbar_wait(full_a(sa), pa);
      const uint32_t stage = a_smem + sa * A_STAGE;
      // not unrolled: unrolled, ptxas hoists the taps' addresses and spills
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
        // this thread's two pixels of the tap's window (stride 1: the halo;
        // stride 2: the window of the tap's plane), a row of the window apart
        int pix0, row_w;
        uint32_t base;
        if constexpr (DOWN2) {
          const int pl = (ky == 1 ? 2 : 0) + (kx == 1 ? 1 : 0);
          row_w = plane_w(pl);
          pix0 = (2 * w + (ky == 2)) * row_w + 8 * wg + g + (kx == 2);
          base = stage + plane_offset(pl);
        } else {
          row_w = HALO_W;
          pix0 = (2 * w + ky) * HALO_W + 8 * wg + g + kx;
          base = stage;
        }
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // a[e]: pixel e & 1, channel 8 ks + q + 4 (e >> 1)
            const int pix = pix0 + (e & 1) * row_w;
            const int chunk = 2 * ks + (e >> 1);
            float v;
            asm volatile("ld.shared.f32 %0, [%1];\n"
                         : "=f"(v)
                         : "r"(base + pix * PIXEL + ((chunk ^ (pix & 7)) << 4) + q * 4)
                         : "memory");
            split(v, hi[ks][e], lo[ks][e]);
          }
        mbar_wait(full_b(sb), pb);
        const uint64_t dhi = smem_desc(b_smem + sb * W_STAGE);
        const uint64_t dlo = smem_desc(b_smem + sb * W_STAGE + W_HALF);
        wgmma_fence();
        // the tap's products in a fresh accumulator, the small ones first
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          wgmma_tf32_rs(part, lo[ks], dhi + 2 * ks, ks > 0);
          wgmma_tf32_rs(part, hi[ks], dlo + 2 * ks);
        }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) wgmma_tf32_rs(part, hi[ks], dhi + 2 * ks);
        wgmma_commit();
        wgmma_wait<0>();  // the fragments' registers and the stages are free again
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
        if (lane == 0) {
          mbar_arrive(empty_b(sb));
          if (tap == 8) mbar_arrive(empty_a(sa));
        }
        if (++sb == SB) sb = 0, pb ^= 1;
      }
      if (++sa == SA) sa = 0, pa ^= 1;
    }

    // Epilogue from the accumulators: d[4j + 2h], d[4j + 2h + 1] are output
    // row y0 + 2w + h, column x0 + 8 wg + g, channels n0 + 8j + 2q and + 1.
    const int x = x0 + 8 * wg + g;
    const bool pairs = (p.Cout & 1) == 0;
    float* obase = p.out + (long long)b * p.H * p.W * p.Cout;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * q;
      if (n >= p.Cout) continue;
      const bool two = n + 1 < p.Cout;
      const float b0 = p.bias != nullptr ? __ldg(p.bias + n) : 0.f;
      const float b1 = p.bias != nullptr && two ? __ldg(p.bias + n + 1) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int y = y0 + 2 * w + h;
        if (y >= p.H || x >= p.W) continue;
        float v0 = acc[4 * j + 2 * h] + b0, v1 = acc[4 * j + 2 * h + 1] + b1;
        if (p.silu) v0 = __fdividef(v0, 1.f + __expf(-v0)), v1 = __fdividef(v1, 1.f + __expf(-v1));
        float* o = obase + ((long long)y * p.W + x) * p.Cout + n;
        if (pairs) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (two) o[1] = v1;
        }
      }
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_tf32x3_kernel(const __grid_constant__ XMaps maps_x,
                      const __grid_constant__ CUtensorMap map_w_hi,
                      const __grid_constant__ CUtensorMap map_w_lo, const Args p) {
  conv_tiles<BN, false>(maps_x, map_w_hi, map_w_lo, p);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_down2_tf32x3_kernel(const __grid_constant__ XMaps maps_x,
                            const __grid_constant__ CUtensorMap map_w_hi,
                            const __grid_constant__ CUtensorMap map_w_lo, const Args p) {
  conv_tiles<BN, true>(maps_x, map_w_hi, map_w_lo, p);
}

// hi = tf32(x), lo = tf32(x - hi), elementwise over n values.
__global__ void split_tf32_kernel(const float* __restrict__ x, float* __restrict__ hi,
                                  float* __restrict__ lo, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint32_t h, l;
    split(x[i], h, l);
    hi[i] = __uint_as_float(h);
    lo[i] = __uint_as_float(l);
  }
}

// a.H and a.W are the input's on entry.  Stride 1: one tensor map over the
// input; stride 2: one per parity plane, plane (py, px) the input read at
// twice the strides from pixel (py, px).
template <int BN, bool DOWN2>
int launch(const void* x, const void* w_hi, const void* w_lo, Args a, int grid,
           cudaStream_t stream) {
  static unsigned long long configured = 0;
  auto kernel = &conv3x3_tf32x3_kernel<BN>;
  if constexpr (DOWN2) kernel = &conv3x3_down2_tf32x3_kernel<BN>;
  constexpr int bytes = smem_bytes(DOWN2, BN);
  if (int err = allow_smem(kernel, bytes, configured)) return err;
  const cuuint64_t cin = a.Cin, wd = a.W, ht = a.H;
  if (DOWN2) a.H /= 2, a.W /= 2;
  a.tiles_x = (a.W + RECT_W - 1) / RECT_W;
  a.tiles_y = (a.H + RECT_H - 1) / RECT_H;
  a.tiles_n = (a.Cout + BN - 1) / BN;
  a.tiles = a.B * a.tiles_y * a.tiles_x * a.tiles_n;
  XMaps maps_x{};
  CUtensorMap map_hi, map_lo;
  int err = 0;
  if (DOWN2) {
    const cuuint64_t x_dims[4] = {cin, wd / 2, ht / 2, (cuuint64_t)a.B};
    const cuuint64_t x_strides[3] = {2 * cin * 4, 2 * wd * cin * 4, ht * wd * cin * 4};
    for (int py = 0; py < 2 && err == 0; ++py)
      for (int px = 0; px < 2 && err == 0; ++px) {
        const cuuint32_t box[4] = {KC, (cuuint32_t)(px == a.pad ? PLANE_W : RECT_W),
                                   (cuuint32_t)(py == a.pad ? PLANE_H : RECT_H), 1};
        err = encode_map_f32(&maps_x.m[2 * py + px],
                             static_cast<const float*>(x) + (py * wd + px) * cin, 4, x_dims,
                             x_strides, box);
      }
  } else {
    const cuuint64_t x_dims[4] = {cin, wd, ht, (cuuint64_t)a.B};
    const cuuint64_t x_strides[3] = {cin * 4, wd * cin * 4, ht * wd * cin * 4};
    const cuuint32_t box[4] = {KC, HALO_W, HALO_H, 1};
    err = encode_map_f32(&maps_x.m[0], x, 4, x_dims, x_strides, box);
  }
  const cuuint64_t w_dims[3] = {cin, 9, (cuuint64_t)a.Cout};
  const cuuint64_t w_strides[2] = {cin * 4, 9 * cin * 4};
  const cuuint32_t w_box[3] = {KC, 1, BN};
  if (err == 0) err = encode_map_f32(&map_hi, w_hi, 3, w_dims, w_strides, w_box);
  if (err == 0) err = encode_map_f32(&map_lo, w_lo, 3, w_dims, w_strides, w_box);
  if (err != 0) return err;
  kernel<<<grid, THREADS, bytes, stream>>>(maps_x, map_hi, map_lo, a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* x, const void* w_hi, const void* w_lo) {
  return (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w_hi) |
          reinterpret_cast<uintptr_t>(w_lo)) % 16 == 0;
}

Args make_args(const void* bias, void* out, int B, int H, int W, int Cin, int Cout, int silu,
               int pad) {
  Args a{};
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.B = B, a.H = H, a.W = W, a.Cin = Cin, a.Cout = Cout, a.silu = silu, a.pad = pad;
  return a;
}

}  // namespace

// What the host-side plans mirror (ops/conv3x3.plan and plan_down2 at item
// size 4) for stride `stride` (1 or 2) and channel tile bn (stride 1: 8, 48,
// 64 or 80; stride 2: 64 or 80): which = 0 the dynamic shared memory in bytes,
// 1 the weight stages, 2 the input channels of a chunk, 3 the input stages;
// -1 for another stride or bn.
extern "C" int conv3x3_tf32x3_geometry(int stride, int bn, int which) {
  const bool down2 = stride == 2;
  if ((stride != 1 && !down2) || (down2 && bn != 64 && bn != 80) ||
      (!down2 && bn != 8 && bn != 48 && bn != 64 && bn != 80))
    return -1;
  switch (which) {
    case 0: return smem_bytes(down2, bn);
    case 1: return w_stages(down2, bn);
    case 2: return KC;
    case 3: return a_stages(down2);
    default: return -1;
  }
}

// w [n] fp32 -> hi, lo [n]: the TF32 split of every value (done once per
// weight, ops/conv_fused.split_tf32).
extern "C" int split_tf32(const void* w, void* hi, void* lo, long long n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  split_tf32_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<float*>(hi), static_cast<float*>(lo), n);
  return static_cast<int>(cudaGetLastError());
}

// x [B, H, W, Cin] fp32 (Cin a multiple of 4, 16-byte aligned), w_hi and w_lo
// [Cout, 3, 3, Cin] (split_tf32 of the OHWI weight), bias [Cout] fp32 or null
// -> out [B, H, W, Cout] fp32, SAME padding; bn and grid from the plan.
extern "C" int conv3x3_tf32x3(const void* x, const void* w_hi, const void* w_lo,
                              const void* bias, void* out, int B, int H, int W, int Cin, int Cout,
                              int silu, int bn, int grid, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 4 || Cin % 4 || Cout < 1 || grid < 1 ||
      !aligned(x, w_hi, w_lo))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(bias, out, B, H, W, Cin, Cout, silu, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 8: return launch<8, false>(x, w_hi, w_lo, a, grid, s);
    case 48: return launch<48, false>(x, w_hi, w_lo, a, grid, s);
    case 64: return launch<64, false>(x, w_hi, w_lo, a, grid, s);
    case 80: return launch<80, false>(x, w_hi, w_lo, a, grid, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x [B, H, W, Cin] fp32 (H, W even; Cin a multiple of 4, 16-byte aligned),
// w_hi and w_lo [Cout, 3, 3, Cin] (split_tf32 of the OHWI weight), bias
// [Cout] fp32 or null -> out [B, H/2, W/2, Cout] fp32; pad 1: padding (1, 1),
// 0: (0, 1); bn and grid from the plan.
extern "C" int conv3x3_down2_tf32x3(const void* x, const void* w_hi, const void* w_lo,
                                    const void* bias, void* out, int B, int H, int W, int Cin,
                                    int Cout, int silu, int pad, int bn, int grid, void* stream) {
  if (B < 1 || H < 2 || W < 2 || H % 2 || W % 2 || Cin < 4 || Cin % 4 || Cout < 1 || grid < 1 ||
      (pad != 0 && pad != 1) || !aligned(x, w_hi, w_lo))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(bias, out, B, H, W, Cin, Cout, silu, pad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 64: return launch<64, true>(x, w_hi, w_lo, a, grid, s);
    case 80: return launch<80, true>(x, w_hi, w_lo, a, grid, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
