// 3x3 convs, NHWC fp32, on the tensor cores in 3xTF32: the fp32 instances of
// the four conv TPU kernels, fastedit_tpu/ops/conv3x3.py `conv3x3`
// (`_conv3x3_call`: SAME, stride 1) and fastedit_tpu/ops/conv_fused.py
// `conv3x3_fused` (`_fused_call` / `_fused_kernel`), `conv3x3_up2`
// (`_up2_call` / `_up2_kernel`) and `conv3x3_down2` (`_down2_call` /
// `_down2_kernel`); bias, optional SiLU and (fused) the skip add in fp32, fp32
// out.  conv3x3.cu holds the bf16 instances of the same design, one template
// for the four forms; here too one core (conv_tiles<BN, FORM>) serves
//
//   conv3x3_tf32x3_kernel<BN>         stride 1 (CONV);
//   conv3x3_fused_tf32x3_kernel<BN>   stride 1 with the resnet block's ops
//       folded in (FUSED): a prologue silu(x * scale[b, c] + shift[b, c]) on
//       every in-image input element (GroupNorm + SiLU, statistics computed
//       outside; the padding ring and channels past Cin stay zero), a bias
//       [Cout] or per batch [B, Cout] (the time embedding folded in), SiLU,
//       then the skip add;
//   conv3x3_up2_tf32x3_kernel<BN>     nearest-2x upsample then 3x3 SAME conv
//       as four 2x2 phase convs of the low-res input (UP2): output pixel (2i
//       + p, 2j + q) sums tap (a, b) of phase (p, q), which reads low-res
//       pixel (i - 1 + a + p, j - 1 + b + q) with the phase weights folded in
//       fp32 (ops/conv_fused.fold_up2), so 16/36 of the materialised conv;
//   conv3x3_down2_tf32x3_kernel<BN>   stride 2, padding (1, 1) for the UNet's,
//       ControlNet's and the conditioning tower's downsamplers or (0, 1) for
//       the VAE encoder's (DOWN2).
//
//   * A stage holds the input pixels a tile of 8 x 16 output pixels reads,
//     for 32 input channels (one 128-byte swizzle row a pixel), landed by TMA
//     with zero fill for the padding, pixels past the image and channels past
//     Cin.  Stride 1, fused and up2: the tile's halo, (8 + 2) x (16 + 2)
//     pixels, 23 KB, one load; three stages.  An up2 tile is a rectangle of 8
//     x 16 LOW-RES pixels and one phase: tap (a, b) of phase (p, q) is the
//     halo at shift (a + p, b + q), so the same halo serves every phase.
//     Stride 2: the windows of the input's four parity planes (odd or even
//     rows x odd or even columns), each a tensor map over [B, H/2, W/2, Cin]
//     read at twice the strides, so that each of the nine taps is a rectangle
//     shift of one plane's window: with padding p, tap k of an axis reads the
//     plane of parity (k + p) & 1 at output coordinate + floor((k - p) / 2);
//     (9 + 8) x (17 + 16) pixels, 70 KB, four loads; two stages.
//   * The weights, OIHW in channels_last memory ([Cout, 9, Cin], K-major as
//     wgmma at .tf32 needs), or up2's phase weights [Cout, 16, Cin] (16 =
//     phase x tap, 4 (2p + q) + 2a + b), split once per weight into hi and lo
//     TF32 copies (split_tf32_kernel; ops/conv_fused.split_tf32, cached by the
//     conv modules per weight version).  A weight stage is one tap's hi and
//     lo for BN output channels and 32 input channels, by two TMA loads; as
//     many stages as fit beside the input's (stride 1, fused and up2: seven or
//     eight, stride 2: four).
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
//     tensor cores busy meanwhile.  Each block walks tiles blockIdx.x, +
//     gridDim.x, ..., (up2: the phase fastest, then) the channel tile.
//   * The fused prologue runs once per staged element, not once per tap, off
//     the consumers' path: warps 9-11 (384 threads; ptxas gives a 288- and a
//     384-thread block the same 168 registers a thread) transform a landed
//     halo stage in place and release it through a "ready" mbarrier, while
//     the consumers multiply the stage before it.  A thread owns one 16-byte
//     chunk of a pixel (4 channels, their scale and shift in registers for
//     the whole stage) and finds it where the swizzle put it.  The split into
//     hi and lo follows, in fp32, when the consumers read the stage.
//   * Channel tiles (ops/conv3x3.plan, plan_up2 and plan_down2 at item size
//     4): the tile's accumulators and the fresh ones of a tap (2 x BN / 2
//     registers) and a tap's fragments (32) fit the 168 registers a thread
//     gets (ptxas budgets whole warpgroups); 160 spilled.  Stride 2: 80 where
//     it divides Cout, else 64.  Stride 1, fused and up2: 8 for the Cout <= 8
//     tails (zero-filled past Cout), else whichever of 80, 64 and 48 wastes
//     the fewest columns (320, 640, 1280: 80; 96: 48; 128, 256, 512: 64).  Cin
//     not a multiple of 32: the last chunk's channels past Cin are zero-filled
//     in both operands and add nothing.
//
// What bounds it on an H100 SXM: operations.  3 x 2 * M * Cout * taps * Cin
// TF32 FLOPs at 494.7 TFLOP/s against x, both weight copies, the skip and the
// output at 3.35 TB/s.  Inside the card the weights' traffic from L2 is the
// nearer limit: every tile of 128 pixels streams the hi and lo weights of its
// channels (8 bytes a weight, 96 TF32 FLOPs a byte: 5.2 TB/s at the tensor
// cores' rate).  No sum is split between blocks: two launches give the same
// bits.

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

enum Form { CONV = 0, DOWN2 = 1, FUSED = 2, UP2 = 3 };

constexpr int RECT_H = 8, RECT_W = 16;  // output pixels of a tile (up2: low-res pixels)
constexpr int KC = 32;                  // input channels of a chunk: 128 bytes
constexpr int PIXEL = KC * 4;           // bytes of a pixel's chunk: one swizzle row
constexpr int HALO_H = RECT_H + 2, HALO_W = RECT_W + 2;  // stride 1, fused, up2
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
__host__ __device__ constexpr int a_stage(int form) {
  return form == DOWN2 ? plane_offset(3) + round_1024(plane_h(3) * plane_w(3) * PIXEL)
                       : round_1024(HALO_H * HALO_W * PIXEL);
}
__host__ __device__ constexpr int a_bytes(int form) {
  return form == DOWN2 ? (PLANE_H + RECT_H) * (PLANE_W + RECT_W) * PIXEL
                       : HALO_H * HALO_W * PIXEL;
}
__host__ __device__ constexpr int a_stages(int form) { return form == DOWN2 ? 2 : 3; }
__host__ __device__ constexpr int max_w_stages(int form) { return form == DOWN2 ? 4 : 8; }
// Weight stages of a chunk (taps of a tile) and of the weights' tensor map.
__host__ __device__ constexpr int taps(int form) { return form == UP2 ? 4 : 9; }
__host__ __device__ constexpr int w_taps(int form) { return form == UP2 ? 16 : 9; }
// The producer asks for the input stage of chunk i + 2 (in the stage of chunk
// i - 1, free once chunk i - 1's last tap has retired) after the weights of
// tap `ask` of chunk i: the weights issued before it are what the consumers
// have in hand while the producer waits for that stage.  Nine taps: after the
// first; up2's four: after the third.
__host__ __device__ constexpr int ask_tap(int form) { return form == UP2 ? 3 : 1; }
constexpr int THREADS = 288;        // two consumer warpgroups and a producer warp
constexpr int FUSED_THREADS = 384;  // and three prologue warps
constexpr int N_XFORM = FUSED_THREADS - THREADS;
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
// full and empty barriers per stage; the fused form's input stages a "ready" one too
__host__ __device__ constexpr int bar_bytes(int form, int sb) {
  return 8 * ((form == FUSED ? 3 : 2) * a_stages(form) + 2 * sb);
}
// Weight stages: as many as fit beside the input stages, at most max_w_stages.
__host__ __device__ constexpr int w_room(int form) {
  return SMEM_LIMIT - 1024 - a_stages(form) * a_stage(form) -
         bar_bytes(form, max_w_stages(form));
}
__host__ __device__ constexpr int w_stages(int form, int bn) {
  return w_room(form) / (2 * w_half(bn)) < max_w_stages(form) ? w_room(form) / (2 * w_half(bn))
                                                              : max_w_stages(form);
}
__host__ __device__ constexpr int smem_bytes(int form, int bn) {
  return 1024 + a_stages(form) * a_stage(form) + w_stages(form, bn) * 2 * w_half(bn) +
         bar_bytes(form, w_stages(form, bn));
}

// x * sigmoid(x) in fp32.  __fdividef: the IEEE division's slow path (taken
// for a zero numerator, for one) made the bf16 prologue 1.8x slower on
// all-zero data.
__device__ __forceinline__ float silu_f(float v) { return __fdividef(v, 1.f + __expf(-v)); }

struct Args {
  const float* bias;   // [bias_rows, Cout] or null
  const float* scale;  // fused: [B, Cin] for the prologue, or null
  const float* shift;  // fused: [B, Cin]
  const float* skip;   // fused: [B, H, W, Cout] or null
  float* out;          // [B, H, W, Cout]; up2: [B, 2H, 2W, Cout]
  int B, H, W, Cin, Cout;  // H, W: the output's (up2: the low-res input's)
  int silu, bias_rows;
  int pad;  // stride 2: padding before the first row and column, 1 or 0
  int tiles_x, tiles_y, tiles_n, tiles;
};

struct XMaps {
  CUtensorMap m[4];  // stride 1: the input, m[0]; stride 2: parity plane (py, px) at 2 py + px
};

// The tiles of one block, every form (the kernels below are this, inlined).
template <int BN, int FORM>
__device__ __forceinline__ void conv_tiles(const XMaps& maps_x, const CUtensorMap& map_w_hi,
                                           const CUtensorMap& map_w_lo, const Args& p) {
  constexpr bool PLANES = FORM == DOWN2;
  constexpr int SA = a_stages(FORM), A_STAGE = a_stage(FORM), A_BYTES = a_bytes(FORM);
  constexpr int SB = w_stages(FORM, BN), W_HALF = w_half(BN), W_STAGE = 2 * W_HALF;
  constexpr int TAPS = taps(FORM);
  static_assert(BN % 8 == 0 && BN <= 256 && SB >= 2, "a channel tile that does not fit");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t a_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t b_smem = a_smem + SA * A_STAGE;
  const uint32_t bars = b_smem + SB * W_STAGE;
  auto full_a = [&](int s) { return bars + 8 * s; };
  auto empty_a = [&](int s) { return bars + 8 * (SA + s); };
  auto full_b = [&](int s) { return bars + 8 * (2 * SA + s); };
  auto empty_b = [&](int s) { return bars + 8 * (2 * SA + SB + s); };
  auto ready_a = [&](int s) { return bars + 8 * (2 * SA + 2 * SB + s); };  // fused only

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ck = (p.Cin + KC - 1) / KC;  // channel chunks
  const bool prenorm = FORM == FUSED && p.scale != nullptr;
  if (threadIdx.x == 0) {
    for (int s = 0; s < SA; ++s) {
      mbar_init(full_a(s), 1);   // the producer's expect_tx
      mbar_init(empty_a(s), 8);  // lane 0 of every consumer warp
      if (FORM == FUSED) mbar_init(ready_a(s), N_XFORM);  // every prologue thread
    }
    for (int s = 0; s < SB; ++s) {
      mbar_init(full_b(s), 1);
      mbar_init(empty_b(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tile t: (up2: the phase fastest, then) the channel tile, the rectangle's
  // column, its row, the image.
  auto tile_at = [&](int t, int& b, int& y0, int& x0, int& n0, int& ph) {
    ph = 0;
    if (FORM == UP2) ph = t & 3, t >>= 2;
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
    // retired, so it is asked for after the weights of chunk i's tap
    // ask_tap.
    int sa = 0, pa = 0, sb = 0, pb = 0;
    int at = blockIdx.x, ac = 0;  // (tile, chunk) of the next input stage
    auto load_window = [&]() {
      if (at >= p.tiles) return;
      int b, y0, x0, n0, ph;
      tile_at(at, b, y0, x0, n0, ph);
      mbar_wait(empty_a(sa), pa ^ 1);
      const uint32_t stage = a_smem + sa * A_STAGE;
      mbar_expect_tx(full_a(sa), A_BYTES);
      if constexpr (PLANES) {
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
      int b, y0, x0, n0, ph;
      tile_at(t, b, y0, x0, n0, ph);
      for (int c = 0; c < ck; ++c) {
        for (int tap = 0; tap < TAPS; ++tap) {
          if (tap == ask_tap(FORM)) load_window();
          mbar_wait(empty_b(sb), pb ^ 1);
          const uint32_t stage = b_smem + sb * W_STAGE;
          const int wtap = FORM == UP2 ? 4 * ph + tap : tap;
          mbar_expect_tx(full_b(sb), W_STAGE);
          tma_load_3d(stage, &map_w_hi, full_b(sb), c * KC, wtap, n0);
          tma_load_3d(stage + W_HALF, &map_w_lo, full_b(sb), c * KC, wtap, n0);
          if (++sb == SB) sb = 0, pb ^= 1;
        }
      }
    }
    return;
  }

  if constexpr (FORM == FUSED) {
    if (warp > 8) {
      // Prologue warps: silu(x * scale + shift) on a landed halo stage, in
      // place, then "ready".  Thread tt owns 16-byte chunk tt & 7 (channels
      // 4 (tt & 7) .. + 3 of the chunk) of pixels tt / 8, tt / 8 + 12, ...
      if (!prenorm) return;
      const int tt = threadIdx.x - THREADS, kc = tt & 7;
      int sa = 0, pa = 0;
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        int b, y0, x0, n0, ph;
        tile_at(t, b, y0, x0, n0, ph);
        for (int c = 0; c < ck; ++c) {
          const int ch = c * KC + 4 * kc;
          float4 s = make_float4(0.f, 0.f, 0.f, 0.f), sh = s;
          if (ch < p.Cin) {  // Cin is a multiple of 4: a chunk is inside or past it whole
            s = __ldg(reinterpret_cast<const float4*>(p.scale + (long long)b * p.Cin + ch));
            sh = __ldg(reinterpret_cast<const float4*>(p.shift + (long long)b * p.Cin + ch));
          }
          mbar_wait(full_a(sa), pa);
          if (ch < p.Cin) {  // channels past Cin stay the zeros TMA wrote
            const uint32_t stage = a_smem + sa * A_STAGE;
            for (int pix = tt >> 3; pix < HALO_H * HALO_W; pix += N_XFORM / 8) {
              const int hy = pix / HALO_W, hx = pix - hy * HALO_W;
              const int gy = y0 - 1 + hy, gx = x0 - 1 + hx;
              if (gy < 0 || gy >= p.H || gx < 0 || gx >= p.W) continue;  // the ring stays zero
              const uint32_t addr = stage + pix * PIXEL + ((kc ^ (pix & 7)) << 4);
              float4 v;
              asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                           : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                           : "r"(addr)
                           : "memory");
              v.x = silu_f(fmaf(v.x, s.x, sh.x));
              v.y = silu_f(fmaf(v.y, s.y, sh.y));
              v.z = silu_f(fmaf(v.z, s.z, sh.z));
              v.w = silu_f(fmaf(v.w, s.w, sh.w));
              asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x),
                           "f"(v.y), "f"(v.z), "f"(v.w)
                           : "memory");
            }
          }
          // TMA overwrites the stage later, through the async proxy.
          fence_async_shared();
          mbar_arrive(ready_a(sa));
          if (++sa == SA) sa = 0, pa ^= 1;
        }
      }
      return;
    }
  }

  // Consumers: warpgroup wg, warp w of it.  wgmma row m is output pixel (row
  // m / 8, column 8 wg + m % 8) of the tile: thread (w, lane) holds rows 16w +
  // lane / 4 and + 8, output rows 2w and 2w + 1 at column 8 wg + lane / 4.
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, q = lane & 3;
  float acc[BN / 2], part[BN / 2];  // part: a tap's fresh accumulators
  int sa = 0, pa = 0, sb = 0, pb = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    int b, y0, x0, n0, ph;
    tile_at(t, b, y0, x0, n0, ph);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int c = 0; c < ck; ++c) {
      mbar_wait(prenorm ? ready_a(sa) : full_a(sa), pa);
      const uint32_t stage = a_smem + sa * A_STAGE;
      // not unrolled: unrolled, ptxas hoists the taps' addresses and spills
#pragma unroll 1
      for (int tap = 0; tap < TAPS; ++tap) {
        // up2: tap (a, b) of phase (p, q) is the halo at shift (a + p, b + q)
        const int ky = FORM == UP2 ? (tap >> 1) + (ph >> 1) : tap / 3;
        const int kx = FORM == UP2 ? (tap & 1) + (ph & 1) : tap % 3;
        // this thread's two pixels of the tap's window (stride 1: the halo;
        // stride 2: the window of the tap's plane), a row of the window apart
        int pix0, row_w;
        uint32_t base;
        if constexpr (PLANES) {
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
          if (tap == TAPS - 1) mbar_arrive(empty_a(sa));
        }
        if (++sb == SB) sb = 0, pb ^= 1;
      }
      if (++sa == SA) sa = 0, pa ^= 1;
    }

    // Epilogue from the accumulators: d[4j + 2h], d[4j + 2h + 1] are output
    // row y0 + 2w + h, column x0 + 8 wg + g (up2: low-res pixel (y, x), output
    // pixel (2y + p, 2x + q)), channels n0 + 8j + 2q and + 1: bias, SiLU, then
    // (fused) the skip, whose rows are read ahead of the stores.
    const int x = x0 + 8 * wg + g;
    const int ho = FORM == UP2 ? 2 * p.H : p.H, wo = FORM == UP2 ? 2 * p.W : p.W;
    const bool pairs = (p.Cout & 1) == 0 &&
                       ((reinterpret_cast<uintptr_t>(p.out) | reinterpret_cast<uintptr_t>(p.skip)) & 7) == 0;
    const float* brow = p.bias;
    if (brow != nullptr && p.bias_rows > 1) brow += (long long)b * p.Cout;
    long long pix[2];  // the thread's two output pixels in the batch, or -1 outside the image
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int y = y0 + 2 * w + h;
      pix[h] = y >= p.H || x >= p.W ? -1
               : FORM == UP2 ? ((long long)b * ho + 2 * y + (ph >> 1)) * wo + 2 * x + (ph & 1)
                             : ((long long)b * ho + y) * wo + x;
    }
    float2 sk[2][BN / 8];
    if constexpr (FORM == FUSED) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = n0 + 8 * j + 2 * q;
          sk[h][j] = make_float2(0.f, 0.f);
          if (p.skip == nullptr || pix[h] < 0 || n >= p.Cout) continue;
          const float* s = p.skip + pix[h] * p.Cout + n;
          if (pairs) {
            sk[h][j] = __ldg(reinterpret_cast<const float2*>(s));
          } else {
            sk[h][j].x = __ldg(s);
            if (n + 1 < p.Cout) sk[h][j].y = __ldg(s + 1);
          }
        }
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * q;
      if (n >= p.Cout) continue;
      const bool two = n + 1 < p.Cout;
      const float b0 = brow != nullptr ? __ldg(brow + n) : 0.f;
      const float b1 = brow != nullptr && two ? __ldg(brow + n + 1) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (pix[h] < 0) continue;
        float v0 = acc[4 * j + 2 * h] + b0, v1 = acc[4 * j + 2 * h + 1] + b1;
        if (p.silu) v0 = silu_f(v0), v1 = silu_f(v1);
        if constexpr (FORM == FUSED) v0 += sk[h][j].x, v1 += sk[h][j].y;
        float* o = p.out + pix[h] * p.Cout + n;
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
  conv_tiles<BN, CONV>(maps_x, map_w_hi, map_w_lo, p);
}

template <int BN>
__global__ void __launch_bounds__(FUSED_THREADS, 1)
conv3x3_fused_tf32x3_kernel(const __grid_constant__ XMaps maps_x,
                            const __grid_constant__ CUtensorMap map_w_hi,
                            const __grid_constant__ CUtensorMap map_w_lo, const Args p) {
  conv_tiles<BN, FUSED>(maps_x, map_w_hi, map_w_lo, p);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_up2_tf32x3_kernel(const __grid_constant__ XMaps maps_x,
                          const __grid_constant__ CUtensorMap map_w_hi,
                          const __grid_constant__ CUtensorMap map_w_lo, const Args p) {
  conv_tiles<BN, UP2>(maps_x, map_w_hi, map_w_lo, p);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_down2_tf32x3_kernel(const __grid_constant__ XMaps maps_x,
                            const __grid_constant__ CUtensorMap map_w_hi,
                            const __grid_constant__ CUtensorMap map_w_lo, const Args p) {
  conv_tiles<BN, DOWN2>(maps_x, map_w_hi, map_w_lo, p);
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

// a.H and a.W are the input's on entry.  Stride 1, fused, up2: one tensor map
// over the input; stride 2: one per parity plane, plane (py, px) the input
// read at twice the strides from pixel (py, px).
template <int BN, int FORM>
int launch(const void* x, const void* w_hi, const void* w_lo, Args a, int grid,
           cudaStream_t stream) {
  static unsigned long long configured = 0;
  auto kernel = [] {
    if constexpr (FORM == DOWN2) return &conv3x3_down2_tf32x3_kernel<BN>;
    else if constexpr (FORM == FUSED) return &conv3x3_fused_tf32x3_kernel<BN>;
    else if constexpr (FORM == UP2) return &conv3x3_up2_tf32x3_kernel<BN>;
    else return &conv3x3_tf32x3_kernel<BN>;
  }();
  constexpr int bytes = smem_bytes(FORM, BN);
  if (int err = allow_smem(kernel, bytes, configured)) return err;
  const cuuint64_t cin = a.Cin, wd = a.W, ht = a.H;
  if (FORM == DOWN2) a.H /= 2, a.W /= 2;
  a.tiles_x = (a.W + RECT_W - 1) / RECT_W;
  a.tiles_y = (a.H + RECT_H - 1) / RECT_H;
  a.tiles_n = (a.Cout + BN - 1) / BN;
  const long long tiles = (long long)a.B * a.tiles_y * a.tiles_x * a.tiles_n * (FORM == UP2 ? 4 : 1);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a.tiles = static_cast<int>(tiles);
  XMaps maps_x{};
  CUtensorMap map_hi, map_lo;
  int err = 0;
  if (FORM == DOWN2) {
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
  constexpr cuuint64_t wt = w_taps(FORM);
  const cuuint64_t w_dims[3] = {cin, wt, (cuuint64_t)a.Cout};
  const cuuint64_t w_strides[2] = {cin * 4, wt * cin * 4};
  const cuuint32_t w_box[3] = {KC, 1, BN};
  if (err == 0) err = encode_map_f32(&map_hi, w_hi, 3, w_dims, w_strides, w_box);
  if (err == 0) err = encode_map_f32(&map_lo, w_lo, 3, w_dims, w_strides, w_box);
  if (err != 0) return err;
  kernel<<<grid, FORM == FUSED ? FUSED_THREADS : THREADS, bytes, stream>>>(maps_x, map_hi,
                                                                           map_lo, a);
  return static_cast<int>(cudaGetLastError());
}

// The instance of form FORM with channel tile bn: stride 2 takes 64 or 80,
// the others 8, 48, 64 or 80.
template <int FORM>
int launch_bn(int bn, const void* x, const void* w_hi, const void* w_lo, const Args& a, int grid,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 64) return launch<64, FORM>(x, w_hi, w_lo, a, grid, s);
  if (bn == 80) return launch<80, FORM>(x, w_hi, w_lo, a, grid, s);
  if constexpr (FORM != DOWN2) {
    if (bn == 8) return launch<8, FORM>(x, w_hi, w_lo, a, grid, s);
    if (bn == 48) return launch<48, FORM>(x, w_hi, w_lo, a, grid, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned(const void* x, const void* w_hi, const void* w_lo) {
  return (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w_hi) |
          reinterpret_cast<uintptr_t>(w_lo)) % 16 == 0;
}

bool valid(int B, int H, int W, int Cin, int Cout, int grid, const void* x, const void* w_hi,
           const void* w_lo) {
  return B >= 1 && H >= 1 && W >= 1 && Cin >= 4 && Cin % 4 == 0 && Cout >= 1 && grid >= 1 &&
         aligned(x, w_hi, w_lo);
}

Args make_args(const void* bias, void* out, int B, int H, int W, int Cin, int Cout, int silu,
               int pad) {
  Args a{};
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.B = B, a.H = H, a.W = W, a.Cin = Cin, a.Cout = Cout, a.silu = silu, a.pad = pad;
  a.bias_rows = 1;
  return a;
}

}  // namespace

// What the host-side plans mirror (ops/conv3x3.plan, plan_up2 and plan_down2
// at item size 4) for form `form` (1 stride 1, 2 stride 2, 3 the fused conv, 4
// the upsample conv) and channel tile bn (stride 2: 64 or 80; the others 8,
// 48, 64 or 80): which = 0 the dynamic shared memory in bytes, 1 the weight
// stages, 2 the input channels of a chunk, 3 the input stages, 4 the threads
// of a block; -1 for another form or bn.
extern "C" int conv3x3_tf32x3_geometry(int form, int bn, int which) {
  const int f = form == 1 ? CONV : form == 2 ? DOWN2 : form == 3 ? FUSED : form == 4 ? UP2 : -1;
  if (f < 0 || (f == DOWN2 && bn != 64 && bn != 80) ||
      (f != DOWN2 && bn != 8 && bn != 48 && bn != 64 && bn != 80))
    return -1;
  switch (which) {
    case 0: return smem_bytes(f, bn);
    case 1: return w_stages(f, bn);
    case 2: return KC;
    case 3: return a_stages(f);
    case 4: return f == FUSED ? FUSED_THREADS : THREADS;
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
  if (!valid(B, H, W, Cin, Cout, grid, x, w_hi, w_lo))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bn<CONV>(bn, x, w_hi, w_lo, make_args(bias, out, B, H, W, Cin, Cout, silu, 1),
                         grid, stream);
}

// As conv3x3_tf32x3, plus: bias [bias_rows, Cout] fp32 or null (bias_rows 1
// or B); scale, shift [B, Cin] fp32 (16-byte aligned) for the prologue, or both
// null; skip [B, H, W, Cout] fp32 or null, added after the bias and SiLU.
extern "C" int conv3x3_fused_tf32x3(const void* x, const void* w_hi, const void* w_lo,
                                    const void* bias, const void* scale, const void* shift,
                                    const void* skip, void* out, int B, int H, int W, int Cin,
                                    int Cout, int silu, int bias_rows, int bn, int grid,
                                    void* stream) {
  if (!valid(B, H, W, Cin, Cout, grid, x, w_hi, w_lo) || (bias_rows != 1 && bias_rows != B) ||
      (scale == nullptr) != (shift == nullptr) ||
      (reinterpret_cast<uintptr_t>(scale) | reinterpret_cast<uintptr_t>(shift)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(bias, out, B, H, W, Cin, Cout, silu, 1);
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.skip = static_cast<const float*>(skip);
  a.bias_rows = bias_rows;
  return launch_bn<FUSED>(bn, x, w_hi, w_lo, a, grid, stream);
}

// x [B, H, W, Cin] fp32 -> out [B, 2H, 2W, Cout] fp32 through the phase
// weights' TF32 copies w_hi and w_lo [Cout, 2, 2, 2, 2, Cin] (split_tf32 of
// ops/conv_fused.fold_up2's fp32 fold); bias [Cout] or null; bn and grid from
// the plan (ops/conv3x3.plan_up2 at item size 4).
extern "C" int conv3x3_up2_tf32x3(const void* x, const void* w_hi, const void* w_lo,
                                  const void* bias, void* out, int B, int H, int W, int Cin,
                                  int Cout, int silu, int bn, int grid, void* stream) {
  if (!valid(B, H, W, Cin, Cout, grid, x, w_hi, w_lo))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bn<UP2>(bn, x, w_hi, w_lo, make_args(bias, out, B, H, W, Cin, Cout, silu, 1),
                        grid, stream);
}

// x [B, H, W, Cin] fp32 (H, W even; Cin a multiple of 4, 16-byte aligned),
// w_hi and w_lo [Cout, 3, 3, Cin] (split_tf32 of the OHWI weight), bias
// [Cout] fp32 or null -> out [B, H/2, W/2, Cout] fp32; pad 1: padding (1, 1),
// 0: (0, 1); bn and grid from the plan.
extern "C" int conv3x3_down2_tf32x3(const void* x, const void* w_hi, const void* w_lo,
                                    const void* bias, void* out, int B, int H, int W, int Cin,
                                    int Cout, int silu, int pad, int bn, int grid, void* stream) {
  if (!valid(B, H, W, Cin, Cout, grid, x, w_hi, w_lo) || H < 2 || W < 2 || H % 2 || W % 2 ||
      (pad != 0 && pad != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bn<DOWN2>(bn, x, w_hi, w_lo, make_args(bias, out, B, H, W, Cin, Cout, silu, pad),
                          grid, stream);
}
