// 3x3 convolutions, NHWC bf16, as implicit GEMMs on the tensor cores with
// fp32 accumulation.  Two kernel bodies, four forms:
//
//   conv3x3_kernel<BN>   3x3 SAME stride 1; replaces
//                         fastedit_tpu/ops/conv3x3.py (`conv3x3` ->
//                         `_conv3x3_call` / `_conv_kernel`).
//   conv3x3_fused_kernel<BN>   the same conv with the resnet block's ops
//                         folded in; replaces fastedit_tpu/ops/conv_fused.py
//                         `conv3x3_fused` (`_fused_call` / `_fused_kernel`): a
//                         prologue silu(x * scale[b, c] + shift[b, c]) on the
//                         input (GroupNorm + SiLU with the statistics computed
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
//   conv3x3_down2_kernel<BN>  stride-2 3x3 conv with padding (1, 1) or the
//                         VAE encoder's (0, 1); replaces `conv3x3_down2`
//                         (`_down2_call` / `_down2_kernel`).  Output (oy, ox),
//                         tap (ky, kx) reads input (2oy + ky - pad, 2ox + kx -
//                         pad): per parity plane of the input (odd or even
//                         rows x odd or even columns) a tap is a rectangle
//                         shift again, as in the TPU kernel's parity-plane
//                         reshape, so it runs on the stride-1 kernel's core.
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
// FLOP/byte), so the tensor cores, not HBM, are the limit.  (The Cout 3 and 4
// tails are bound by the bytes of their input.  Inside the card the weights'
// traffic from L2 is the nearer limit: every tile of 128 pixels reads its
// BN x 9 x Cin weights again.)
//
// GEMM view of all forms:  out[m, n] = sum_k A[m, k] * Wt[n, k]  with
//   m = output pixel (b, y, x), n = output channel, k = (tap, cin).
// A is never materialised, and the weight is read in OHWI order (torch's OIHW
// in channels_last memory; the up2 phase weights as [phase, tap, Cout, Cin]),
// so both operands are K-contiguous.
//
// The stride-1 forms (conv_tiles), written for Hopper:
//   * wgmma.mma_async m64nBNk16 with fp32 accumulators in registers; both
//     operands are read from shared memory through descriptors, in the
//     128-byte swizzle that a row of 64 bf16 fills exactly.
//   * One output tile is a rectangle of 8 x 16 pixels of one image times BN
//     output channels.  Per 64-channel chunk of Cin the tile's 10 x 18 halo
//     rectangle is staged ONCE, by one TMA load over [B, H, W, Cin] at the
//     possibly negative coordinate (x0 - 1, y0 - 1): the hardware zero-fills
//     the padding ring, channels past Cin and pixels past the image, so no
//     copy is predicated, and the batch is a tensor-map dimension of box 1,
//     so a rectangle never straddles two images.  All nine taps are read
//     from that halo.  A consumer warpgroup owns 8 rows x 8 columns; the 8
//     wgmma rows of one group are 8 neighbouring halo pixels (128 bytes
//     apart) and the next group lies one halo row (18 pixels) on, so a tap's
//     A operand is a descriptor whose start address carries the tap's shift
//     and whose group stride is the halo row.  The swizzle is a function of
//     the shared-memory address, which is how TMA wrote the stage, so the
//     start address need not lie on a 1024-byte boundary.  (A from
//     registers, one ldmatrix row address per lane, measured 8-12% slower:
//     ptxas serialises wgmmas whose A registers are written while another
//     group is in flight, warning C7513.)
//   * One weight stage is one tap: BN channels x 64 Cin, one TMA load over
//     [Cout, 9, Cin] that zero-fills past Cout and past Cin.
//   * The block is warp-specialised and persistent.  Warp 0 is the producer:
//     one thread keeps a ring of 3 halo stages and a ring of 6 weight stages
//     full, completion reported to "full" mbarriers.  Two consumer
//     warpgroups wait on them, multiply, and arrive on the "empty" mbarriers
//     once the wgmma group that read a stage has retired; no __syncthreads()
//     after set-up.  Each block walks tiles blockIdx.x, + gridDim.x, ...
//     (channel tile fastest, so neighbouring blocks share a halo in L2);
//     barrier phases carry over from tile to tile, so the next tile's loads
//     run under this tile's epilogue.  The producer asks for halo i + 1
//     before the nine taps of chunk i, so a halo has a whole chunk's
//     multiplies to land (and be transformed) in.  Nobody needs more
//     registers than the launch gives every thread (ptxas: at most 115 used,
//     no spills), so there is no setmaxnreg.
//   * The fused prologue is done once per staged element, not once per tap,
//     and off the consumers' path: seven more warps (a fourth warpgroup and
//     the producer's three idle neighbours) transform a landed halo stage in
//     place behind its own "ready" barrier while the consumers multiply the
//     previous one.  Pixels outside the image and channels past Cin are left
//     as the zeros TMA wrote: silu(0 * s + t) is not 0, and SAME semantics
//     need the ring to stay zero after the normalisation.
//   * BN is 160 where it divides Cout (the UNet's 320, 640, 1280: no wasted
//     column and a grid that fills 132 SMs), 8 for Cout <= 8 (the Cout 3 and
//     4 tails), else 128.  The host-side plan (ops/conv3x3.py `plan`) picks
//     it and the grid; both arrive here as ints.
//   * The epilogue works on the accumulator registers directly and masks
//     ragged Cout and the pixels of a rectangle that fall outside the image.
//
// The stride-2 form on the same core (conv_tiles<BN, false, true>):
//   * The plane (py, px) of the input is a strided view of it (twice the row
//     and column strides from pixel (py, px)), so it gets a tensor map of its
//     own over [B, H/2, W/2, Cin] and its window lands by one TMA load,
//     zero-filled outside the plane and past Cin like a halo.  With padding
//     p, tap k of an axis reads the plane of parity (k + p) & 1 at output
//     coordinate + floor((k - p) / 2): the plane of parity p serves taps 0
//     and 2 at shifts 0 and 1 of a window that starts at (tile start - p) and
//     is one pixel longer than the tile; the other plane serves tap 1.  Both
//     paddings therefore differ only in which plane is which and where a
//     window starts.  A stage is the four windows of an 8 x 16 output tile,
//     (9 + 8) x (17 + 16) pixels x 64 channels = 70 KB: two stages, and four
//     weight stages.
//   * Channel tiles of 160, 128, 80 and 64: the main path's calls are small
//     (2 x 32 x 32 outputs x 640 channels is 64 tiles at BN 160 for 132 SMs),
//     so the plan halves the channel tile where that fills the card.
//   * No sum is split between blocks: two launches give the same bits.
//
// The up2 form keeps the mma.sync body (up2_body): tiles of 128 pixels x 128
// output channels x 64 k in a 3-stage cp.async ring, 8 warps with 64x32
// sub-tiles read with ldmatrix; pixels in the padding ring, channels past Cin
// and rows past M are zero-filled by the copy itself (src-size 0).

#include "hopper.cuh"

namespace {

using namespace hopper;

// x * sigmoid(x).  __fdividef: the IEEE division's slow path (taken for a
// zero numerator, for one) made the prologue 1.8x slower on all-zero data.
__device__ __forceinline__ float silu_f(float t) { return __fdividef(t, 1.f + __expf(-t)); }

// ---------------------------------------------------------------- stride 1

constexpr int RECT_H = 8;    // output pixels per tile: 8 rows x 16 columns
constexpr int RECT_W = 16;
constexpr int HALO_H = RECT_H + 2;
constexpr int HALO_W = RECT_W + 2;
constexpr int HALO_PIX = HALO_H * HALO_W;
constexpr int KC = 64;       // input channels per chunk: one 128-byte swizzle row
constexpr int A_BYTES = HALO_PIX * KC * 2;               // one TMA load of a halo
constexpr int S1_A_STAGE = (A_BYTES + 1023) / 1024 * 1024;  // stages stay 1024-byte aligned
constexpr int S1_SA = 3;     // halo stages
constexpr int S1_SB = 6;     // weight stages (one tap x 64 Cin x BN each)
constexpr int TILE_THREADS = 384;   // warp 0 producer (1-3 idle), 2 consumer warpgroups
constexpr int FUSED_THREADS = 512;  // fused: warps 1-3 and a fourth warpgroup do the prologue
constexpr int N_XFORM = FUSED_THREADS - TILE_THREADS + 96;  // prologue threads (a multiple of 8)


// Stride 2: a stage holds the tile's window of the four parity planes of the
// input (row parity x column parity).  A plane whose parity equals the
// padding serves taps 0 and 2 of its axis and is one pixel larger along it
// ("big"); the other serves tap 1.  Planes in the order big/big, big/small,
// small/big, small/small (rows/columns), each on a 1024-byte boundary.
constexpr int PLANE_H = RECT_H + 1;
constexpr int PLANE_W = RECT_W + 1;
__host__ __device__ constexpr int round_1024(int n) { return (n + 1023) / 1024 * 1024; }
__host__ __device__ constexpr int plane_h(int pl) { return pl < 2 ? PLANE_H : RECT_H; }
__host__ __device__ constexpr int plane_w(int pl) { return pl % 2 == 0 ? PLANE_W : RECT_W; }
__host__ __device__ constexpr int plane_offset(int pl) {
  return pl == 0 ? 0
                 : plane_offset(pl - 1) + round_1024(plane_h(pl - 1) * plane_w(pl - 1) * KC * 2);
}
constexpr int D2_A_STAGE = plane_offset(3) + round_1024(plane_h(3) * plane_w(3) * KC * 2);
constexpr int D2_A_BYTES = (PLANE_H + RECT_H) * (PLANE_W + RECT_W) * KC * 2;  // four TMA loads
constexpr int D2_SA = 2;     // stages of four planes
constexpr int D2_SB = 4;     // weight stages

constexpr int tiles_smem_bytes(int bn, bool down2 = false) {
  return down2 ? 1024 + D2_SA * D2_A_STAGE + D2_SB * bn * KC * 2 + 8 * (3 * D2_SA + 2 * D2_SB)
               : 1024 + S1_SA * S1_A_STAGE + S1_SB * bn * KC * 2 + 8 * (3 * S1_SA + 2 * S1_SB);
}

struct TileArgs {
  const float* bias;          // [bias_rows, Cout] or null
  const float* scale;         // fused: [B, Cin], or null for no prologue
  const float* shift;         // fused: [B, Cin]
  const __nv_bfloat16* skip;  // fused: [B, H, W, Cout] or null
  __nv_bfloat16* out;         // [B, H, W, Cout]
  int B, H, W, Cin, Cout;     // H, W: the output's (stride 2: half the input's)
  int silu, bias_rows;
  int pad;                    // stride 2: padding before the first row and column, 1 or 0
  int tiles_x, tiles_y, tiles_n, tiles;  // rectangles per row, per column; channel tiles; all
};

// The x tensor maps of a kernel: one for stride 1; for stride 2 one per
// parity plane, index 2 * (row parity) + column parity.
struct XMaps {
  CUtensorMap m[4];
};

// Tile t of the persistent walk: channel tile fastest, then the rectangle's
// column, its row, the image.
struct Tile {
  int b, y0, x0, n0;
};
template <int BN>
__device__ __forceinline__ Tile tile_at(const TileArgs& p, int t) {
  Tile r;
  const int m = t / p.tiles_n;
  r.n0 = (t - m * p.tiles_n) * BN;
  const int row = m / p.tiles_x;
  r.x0 = (m - row * p.tiles_x) * RECT_W;
  r.b = row / p.tiles_y;
  r.y0 = (row - r.b * p.tiles_y) * RECT_H;
  return r;
}

template <int BN, bool FUSED, bool DOWN2 = false>
__device__ __forceinline__ void conv_tiles(const CUtensorMap* maps_x, const CUtensorMap& map_w,
                                           const TileArgs& p) {
  static_assert(!(FUSED && DOWN2), "the fused form is stride 1");
  constexpr int B_STAGE = BN * KC * 2;
  constexpr int SA = DOWN2 ? D2_SA : S1_SA, SB = DOWN2 ? D2_SB : S1_SB;
  constexpr int A_STAGE = DOWN2 ? D2_A_STAGE : S1_A_STAGE;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t a_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t b_smem = a_smem + SA * A_STAGE;
  const uint32_t bars = b_smem + SB * B_STAGE;
  auto full_a = [&](int s) { return bars + 8 * s; };
  auto ready_a = [&](int s) { return bars + 8 * (SA + s); };
  auto empty_a = [&](int s) { return bars + 8 * (2 * SA + s); };
  auto full_b = [&](int s) { return bars + 8 * (3 * SA + s); };
  auto empty_b = [&](int s) { return bars + 8 * (3 * SA + SB + s); };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int H = p.H, W = p.W, Cin = p.Cin, Cout = p.Cout;
  const int ck = (Cin + KC - 1) / KC;  // channel chunks
  const bool prenorm = FUSED && p.scale != nullptr;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SA; ++s) {
      mbar_init(full_a(s), 1);         // the producer's expect_tx
      mbar_init(ready_a(s), N_XFORM);  // every prologue thread
      mbar_init(empty_a(s), 8);        // lane 0 of every consumer warp
    }
    for (int s = 0; s < SB; ++s) {
      mbar_init(full_b(s), 1);
      mbar_init(empty_b(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    if (lane != 0) return;
    // Producer: the next free stage of each ring, in the consumers' order.
    // The halo runs one chunk ahead of the weights (halo i + 1 is asked for
    // before the nine taps of chunk i), so that a halo has a whole chunk's
    // multiplies to land and be transformed in.  Its stage was freed when
    // the consumers began chunk i - 1, whose weights are already on their
    // way, so the order cannot deadlock.  Stride 2 has two stages only: halo
    // i + 1 takes the stage of chunk i - 1, which the consumers free at tap 0
    // of chunk i, so it is asked for after that tap's weights.
    int sa = 0, pa = 0, sb = 0, pb = 0;
    int at = blockIdx.x, ac = 0;  // (tile, chunk) of the next halo
    auto load_halo = [&]() {
      if (at >= p.tiles) return;
      const Tile tl = tile_at<BN>(p, at);
      mbar_wait(empty_a(sa), pa ^ 1);
      const uint32_t stage = a_smem + sa * A_STAGE;
      if (DOWN2) {
        mbar_expect_tx(full_a(sa), D2_A_BYTES);
#pragma unroll
        for (int pl = 0; pl < 4; ++pl) {
          // Output (oy, ox), tap (ky, kx) reads input (2 oy + ky - pad, ...):
          // the plane of parity (ky - pad) & 1 at oy + floor((ky - pad) / 2).
          const int py = pl < 2 ? p.pad : 1 - p.pad, px = pl % 2 == 0 ? p.pad : 1 - p.pad;
          tma_load_4d(stage + plane_offset(pl), &maps_x[2 * py + px], full_a(sa), ac * KC,
                      tl.x0 - (pl % 2 == 0 ? p.pad : 0), tl.y0 - (pl < 2 ? p.pad : 0), tl.b);
        }
      } else {
        mbar_expect_tx(full_a(sa), A_BYTES);
        tma_load_4d(stage, maps_x, full_a(sa), ac * KC, tl.x0 - 1, tl.y0 - 1, tl.b);
      }
      if (++sa == SA) sa = 0, pa ^= 1;
      if (++ac == ck) ac = 0, at += gridDim.x;
    };
    load_halo();
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const Tile tl = tile_at<BN>(p, t);
      for (int c = 0; c < ck; ++c) {
        for (int tap = 0; tap < 9; ++tap) {
          if (tap == (DOWN2 ? 1 : 0)) load_halo();
          mbar_wait(empty_b(sb), pb ^ 1);
          mbar_expect_tx(full_b(sb), B_STAGE);
          tma_load_3d(b_smem + sb * B_STAGE, &map_w, full_b(sb), c * KC, tap, tl.n0);
          if (++sb == SB) sb = 0, pb ^= 1;
        }
      }
    }
  } else if (warp >= 4 && warp < 12) {
    // Consumers: warpgroup wg owns rectangle columns 8wg .. 8wg+7 of all 8
    // rows; its wgmma row m is the pixel of row m / 8, column 8wg + m % 8.
    // The 8 rows of one group are 8 neighbouring halo pixels, 128 bytes
    // apart, and the next group lies one halo row on: a descriptor.  Stride
    // 2: the same inside the tap's parity plane, where the pixels a tap
    // reads for neighbouring outputs are neighbours; taps 0 and 1 of an axis
    // start at the plane window's first row or column, tap 2 one further.
    const int wg = (warp >> 2) - 1, w = warp & 3;
    float acc[BN / 2];
    int sa = 0, pa = 0, sb = 0, pb = 0;
    // Stages whose last wgmma group has not been waited for yet.
    int sa_prev = -1, sb_prev = -1;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const Tile tl = tile_at<BN>(p, t);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int c = 0; c < ck; ++c) {
        if (FUSED && p.skip != nullptr && c == ck - 1) {
          // The epilogue's skip rows, asked for one chunk ahead: the 4 lanes
          // that share a pixel take one 128-byte line each.
          const int x = tl.x0 + 8 * wg + (lane >> 2);
          const int n = tl.n0 + (lane & 3) * 64;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int y = tl.y0 + 2 * w + h;
            if (y < H && x < W && n < Cout && n < tl.n0 + BN)
              asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
                  p.skip + (((long long)tl.b * H + y) * W + x) * Cout + n));
          }
        }
        mbar_wait(prenorm ? ready_a(sa) : full_a(sa), pa);
        const uint32_t stage = a_smem + sa * A_STAGE;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          mbar_wait(full_b(sb), pb);
          const int ky = tap / 3, kx = tap % 3;
          const int pl = (ky == 1 ? 2 : 0) + (kx == 1 ? 1 : 0);
          const int row_pixels = DOWN2 ? plane_w(pl) : HALO_W;
          const int first = DOWN2 ? plane_offset(pl) + ((ky == 2) * row_pixels + (kx == 2)) * 128
                                  : (ky * HALO_W + kx) * 128;
          const uint64_t da = smem_desc(stage + first + 8 * wg * 128, row_pixels * 128);
          const uint64_t db = smem_desc(b_smem + sb * B_STAGE);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) wgmma_ss(acc, da + 2 * ks, db + 2 * ks);
          wgmma_commit();
          wgmma_wait<1>();  // the previous tap's group is done: its operands are free
          if (lane == 0) {
            if (sb_prev >= 0) mbar_arrive(empty_b(sb_prev));
            if (tap == 0 && sa_prev >= 0) mbar_arrive(empty_a(sa_prev));
          }
          sb_prev = sb;
          if (++sb == SB) sb = 0, pb ^= 1;
        }
        sa_prev = sa;
        if (++sa == SA) sa = 0, pa ^= 1;
      }
      wgmma_wait<0>();
      if (lane == 0) {
        mbar_arrive(empty_b(sb_prev));
        mbar_arrive(empty_a(sa_prev));
      }
      sa_prev = sb_prev = -1;

      // Epilogue from the accumulators: d[4j + 2h], d[4j + 2h + 1] sit at
      // wgmma row 16w + lane / 4 + 8h, channels n0 + 8j + 2(lane % 4), + 1.
      // Channel pairs go as one access where every pair is aligned.
      const bool pair_store = (Cout & 1) == 0 && (reinterpret_cast<uintptr_t>(p.bias) & 7) == 0 &&
                              (!FUSED || (reinterpret_cast<uintptr_t>(p.skip) & 3) == 0);
      const int x = tl.x0 + 8 * wg + (lane >> 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int y = tl.y0 + 2 * w + h;
        if (y >= H || x >= W) continue;
        const long long pix = ((long long)tl.b * H + y) * W + x;
        __nv_bfloat16* orow = p.out + pix * Cout;
        const float* brow = p.bias;
        if (FUSED && brow != nullptr && p.bias_rows > 1) brow += (long long)tl.b * Cout;
        const __nv_bfloat16* srow = FUSED && p.skip != nullptr ? p.skip + pix * Cout : nullptr;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = tl.n0 + j * 8 + (lane & 3) * 2;
          if (n >= Cout) continue;
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (pair_store) {  // n is even, so n + 1 < Cout too, and the pairs are aligned
            if (brow != nullptr) {
              const float2 bb = *reinterpret_cast<const float2*>(brow + n);
              v0 += bb.x, v1 += bb.y;
            }
            if (p.silu) v0 = silu_f(v0), v1 = silu_f(v1);
            if (FUSED && srow != nullptr) {
              const float2 sk =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(srow + n));
              v0 += sk.x, v1 += sk.y;
            }
            *reinterpret_cast<__nv_bfloat162*>(orow + n) = __floats2bfloat162_rn(v0, v1);
          } else {
            float v[2] = {v0, v1};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (n + e >= Cout) continue;
              if (brow != nullptr) v[e] += brow[n + e];
              if (p.silu) v[e] = silu_f(v[e]);
              if (FUSED && srow != nullptr) v[e] += __bfloat162float(srow[n + e]);
              orow[n + e] = __float2bfloat16(v[e]);
            }
          }
        }
      }
    }
  } else if (prenorm) {
    // Prologue warps (1-3 and 12-15): silu(x * scale + shift) on a landed
    // halo stage, in place.  Thread tt owns the 16-byte vector (tt & 7) of
    // pixels tt / 8, tt / 8 + 28, ...: its 8 channels are fixed in a chunk.
    const int tt = threadIdx.x - (warp < 4 ? 32 : TILE_THREADS - 96);
    const int kc = tt & 7;
    int sa = 0, pa = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const Tile tl = tile_at<BN>(p, t);
      for (int c = 0; c < ck; ++c) {
        const int ch = c * KC + kc * 8;
        float s[8], sh[8];
        if (ch < Cin) {
          const float4* sp = reinterpret_cast<const float4*>(p.scale + (long long)tl.b * Cin + ch);
          const float4* tp = reinterpret_cast<const float4*>(p.shift + (long long)tl.b * Cin + ch);
          const float4 s0 = sp[0], s1 = sp[1], t0 = tp[0], t1 = tp[1];
          s[0] = s0.x, s[1] = s0.y, s[2] = s0.z, s[3] = s0.w;
          s[4] = s1.x, s[5] = s1.y, s[6] = s1.z, s[7] = s1.w;
          sh[0] = t0.x, sh[1] = t0.y, sh[2] = t0.z, sh[3] = t0.w;
          sh[4] = t1.x, sh[5] = t1.y, sh[6] = t1.z, sh[7] = t1.w;
        }
        mbar_wait(full_a(sa), pa);
        if (ch < Cin) {
          const uint32_t stage = a_smem + sa * A_STAGE;
          for (int v = tt; v < HALO_PIX * 8; v += N_XFORM) {
            const int pix = v >> 3;
            const int hy = pix / HALO_W, hx = pix - hy * HALO_W;
            const int gy = tl.y0 - 1 + hy, gx = tl.x0 - 1 + hx;
            if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;  // the ring stays zero
            const uint32_t addr = stage + pix * 128 + ((kc ^ (pix & 7)) << 4);
            uint32_t r[4];
            asm volatile("ld.shared.v4.u32 {%0,%1,%2,%3}, [%4];\n"
                         : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                         : "r"(addr)
                         : "memory");
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r[e]));
              const __nv_bfloat162 h =
                  __floats2bfloat162_rn(silu_f(f.x * s[2 * e] + sh[2 * e]),
                                        silu_f(f.y * s[2 * e + 1] + sh[2 * e + 1]));
              r[e] = *reinterpret_cast<const uint32_t*>(&h);
            }
            asm volatile("st.shared.v4.u32 [%0], {%1,%2,%3,%4};\n" ::"r"(addr), "r"(r[0]),
                         "r"(r[1]), "r"(r[2]), "r"(r[3])
                         : "memory");
          }
        }
        // wgmma reads the stage, and TMA overwrites it, through the async proxy.
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(ready_a(sa));
        if (++sa == SA) sa = 0, pa ^= 1;
      }
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(TILE_THREADS, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_w, const TileArgs p) {
  conv_tiles<BN, false>(&map_x, map_w, p);
}
template <int BN>
__global__ void __launch_bounds__(FUSED_THREADS, 1)
conv3x3_fused_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w, const TileArgs p) {
  conv_tiles<BN, true>(&map_x, map_w, p);
}
template <int BN>
__global__ void __launch_bounds__(TILE_THREADS, 1)
conv3x3_down2_kernel(const __grid_constant__ XMaps maps_x,
                     const __grid_constant__ CUtensorMap map_w, const TileArgs p) {
  conv_tiles<BN, false, true>(maps_x.m, map_w, p);
}

template <int BN, bool FUSED>
int launch_tiles(const void* x, const void* w, TileArgs a, int grid, void* stream) {
  static unsigned long long configured = 0;  // one bit per device
  constexpr int smem = tiles_smem_bytes(BN);
  auto kernel = FUSED ? conv3x3_fused_kernel<BN> : conv3x3_kernel<BN>;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!(configured >> (device & 63) & 1)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured |= 1ull << (device & 63);
  }
  a.tiles_x = (a.W + RECT_W - 1) / RECT_W;
  a.tiles_y = (a.H + RECT_H - 1) / RECT_H;
  a.tiles_n = (a.Cout + BN - 1) / BN;
  a.tiles = a.B * a.tiles_y * a.tiles_x * a.tiles_n;
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_w;
  const cuuint64_t cin = a.Cin, wd = a.W, ht = a.H;
  const cuuint64_t x_dims[4] = {cin, wd, ht, (cuuint64_t)a.B};
  const cuuint64_t x_strides[3] = {cin * 2, wd * cin * 2, ht * wd * cin * 2};
  const cuuint32_t x_box[4] = {KC, HALO_W, HALO_H, 1};
  const cuuint64_t w_dims[3] = {cin, 9, (cuuint64_t)a.Cout};
  const cuuint64_t w_strides[2] = {cin * 2, 9 * cin * 2};
  const cuuint32_t w_box[3] = {KC, 1, BN};
  int err = encode_map(&map_x, x, 4, x_dims, x_strides, x_box);
  if (err == 0) err = encode_map(&map_w, w, 3, w_dims, w_strides, w_box);
  if (err != 0) return err;
  kernel<<<grid, FUSED ? FUSED_THREADS : TILE_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      map_x, map_w, a);
  return static_cast<int>(cudaGetLastError());
}

// Stride 2: a.H and a.W are the input's on entry.  One tensor map per parity
// plane: the plane (py, px) is the input read at twice the strides from pixel
// (py, px), so its pixels are stride-1 neighbours and its edges zero-fill.
template <int BN>
int launch_down2(const void* x, const void* w, TileArgs a, int grid, void* stream) {
  static unsigned long long configured = 0;  // one bit per device
  constexpr int smem = tiles_smem_bytes(BN, true);
  auto kernel = conv3x3_down2_kernel<BN>;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!(configured >> (device & 63) & 1)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured |= 1ull << (device & 63);
  }
  const cuuint64_t cin = a.Cin, wd = a.W, ht = a.H;
  a.H /= 2, a.W /= 2;
  a.tiles_x = (a.W + RECT_W - 1) / RECT_W;
  a.tiles_y = (a.H + RECT_H - 1) / RECT_H;
  a.tiles_n = (a.Cout + BN - 1) / BN;
  a.tiles = a.B * a.tiles_y * a.tiles_x * a.tiles_n;
  if (grid < 1 || (a.pad != 0 && a.pad != 1)) return static_cast<int>(cudaErrorInvalidValue);
  XMaps maps_x;
  CUtensorMap map_w;
  const cuuint64_t x_dims[4] = {cin, wd / 2, ht / 2, (cuuint64_t)a.B};
  const cuuint64_t x_strides[3] = {2 * cin * 2, 2 * wd * cin * 2, ht * wd * cin * 2};
  int err = 0;
  for (int py = 0; py < 2 && err == 0; ++py)
    for (int px = 0; px < 2 && err == 0; ++px) {
      const cuuint32_t box[4] = {KC, (cuuint32_t)(px == a.pad ? PLANE_W : RECT_W),
                                 (cuuint32_t)(py == a.pad ? PLANE_H : RECT_H), 1};
      err = encode_map(&maps_x.m[2 * py + px],
                       static_cast<const __nv_bfloat16*>(x) + (py * wd + px) * cin, 4, x_dims,
                       x_strides, box);
    }
  const cuuint64_t w_dims[3] = {cin, 9, (cuuint64_t)a.Cout};
  const cuuint64_t w_strides[2] = {cin * 2, 9 * cin * 2};
  const cuuint32_t w_box[3] = {KC, 1, BN};
  if (err == 0) err = encode_map(&map_w, w, 3, w_dims, w_strides, w_box);
  if (err != 0) return err;
  kernel<<<grid, TILE_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(maps_x, map_w, a);
  return static_cast<int>(cudaGetLastError());
}

// The instance for channel tile bn (ops/conv3x3.py `plan` picks it).
template <bool FUSED>
int launch_tiles_bn(int bn, const void* x, const void* w, const TileArgs& a, int grid,
                    void* stream) {
  switch (bn) {
    case 8: return launch_tiles<8, FUSED>(x, w, a, grid, stream);
    case 128: return launch_tiles<128, FUSED>(x, w, a, grid, stream);
    case 160: return launch_tiles<160, FUSED>(x, w, a, grid, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------------------------------- up2

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

struct ConvArgs {
  const __nv_bfloat16* x;     // [B, H, W, Cin]
  const __nv_bfloat16* w;     // [4 phases, 4 taps, Cout, Cin]
  const float* bias;          // [Cout] or null
  __nv_bfloat16* out;         // [B, 2H, 2W, Cout]
  int B, H, W, Cin, Cout;
  int Ho, Wo;                 // the GEMM's pixel grid: one phase's
  int silu;
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

// Four 8x8 bf16 matrices from shared memory; lane l supplies the address of
// row (l & 7) of matrix (l >> 3) and receives its share of each in r[0..3].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t smem_addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr)
               : "memory");
}

__device__ __forceinline__ void up2_body(const ConvArgs& p) {
  constexpr int KW = 2;  // taps per row
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
  const int phase = (int)blockIdx.z;  // 2p + q
  const __nv_bfloat16* w = p.w + (long long)phase * NTAP * Cout * Cin;

  // Each thread copies RPT 16-byte vectors of A and of B per stage: rows
  // (tid / VPR) + (256 / VPR) * i, vector (tid % VPR) of the 64-wide k.
  // ay, ax: input pixel read by tap (0, 0); apix: pixel index of (b, 0, 0)
  // in the input, -1 past M.
  const int vec = tid % VPR;
  const int row0 = tid / VPR;
  constexpr int ROW_STEP = NTHREADS / VPR;
  int ay[RPT], ax[RPT], apix[RPT];
  for (int i = 0; i < RPT; ++i) {
    const long long m = m0 + row0 + ROW_STEP * i;
    const long long mm = m < M ? m : 0;
    const int b = (int)(mm / HWo);
    const int r = (int)(mm - (long long)b * HWo);
    const int oy = r / p.Wo, ox = r - (r / p.Wo) * p.Wo;
    ay[i] = oy + (phase >> 1) - 1;
    ax[i] = ox + (phase & 1) - 1;
    apix[i] = m < M ? b * H * W : -1;
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
      const long long off = ((long long)ld_tap * Cout + n) * Cin + c;
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
        ldmatrix_x4(af[i], smem_u32(as + (wm * WM + i * 16 + a_row) * LDS + ks + a_k));
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t r[4];
        ldmatrix_x4(r, smem_u32(bs + (wn * WN + jp * 16 + b_row) * LDS + ks + b_k));
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
      const float* brow = p.bias;
      const long long b = m / HWo;
      const int r = (int)(m - b * HWo);
      const int oy = r / p.Wo, ox = r - (r / p.Wo) * p.Wo;
      const long long opix =
          (b * 2 * p.Ho + 2 * oy + (phase >> 1)) * (2LL * p.Wo) + 2 * ox + (phase & 1);
      __nv_bfloat16* orow = p.out + opix * Cout;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + wn * WN + j * 8 + tg * 2;
        float v[2];
        for (int e = 0; e < 2; ++e) {
          float t = acc[i][j][half * 2 + e];
          if (brow != nullptr && n + e < Cout) t += brow[n + e];
          if (p.silu) t = silu_f(t);
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

__global__ void __launch_bounds__(NTHREADS, 2) conv3x3_up2_kernel(const ConvArgs p) {
  up2_body(p);
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
// GEMM's (pixel tile, channel tile, phase) grid.
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
  a.Ho = H, a.Wo = W, a.silu = silu;
  return a;
}

}  // namespace

// Dynamic shared memory of the stride-1 instance with channel tile bn (the
// host-side plan mirrors it), or -1 where there is no such instance.
extern "C" int conv3x3_smem_bytes(int bn) {
  return bn == 8 || bn == 128 || bn == 160 ? tiles_smem_bytes(bn) : -1;
}
// The same for the stride-2 instances.
extern "C" int conv3x3_down2_smem_bytes(int bn) {
  return bn == 64 || bn == 80 || bn == 128 || bn == 160 ? tiles_smem_bytes(bn, true) : -1;
}

// x [B, H, W, Cin], w [Cout, 3, 3, Cin], bias [Cout] fp32 or null -> out
// [B, H, W, Cout]; bn and grid from the plan (ops/conv3x3.py).
extern "C" int conv3x3_bf16(const void* x, const void* w, const void* bias, void* out,
                            int B, int H, int W, int Cin, int Cout, int silu, int bn, int grid,
                            void* stream) {
  TileArgs a{};
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B, a.H = H, a.W = W, a.Cin = Cin, a.Cout = Cout, a.silu = silu, a.bias_rows = 1;
  return launch_tiles_bn<false>(bn, x, w, a, grid, stream);
}

// As conv3x3_bf16, plus: bias [bias_rows, Cout] fp32 (bias_rows 1 or B);
// scale, shift [B, Cin] fp32 for the prologue, or both null; skip
// [B, H, W, Cout] bf16 or null.
extern "C" int conv3x3_fused_bf16(const void* x, const void* w, const void* bias,
                                  const void* scale, const void* shift, const void* skip,
                                  void* out, int B, int H, int W, int Cin, int Cout, int silu,
                                  int bias_rows, int bn, int grid, void* stream) {
  TileArgs a{};
  a.bias = static_cast<const float*>(bias);
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.skip = static_cast<const __nv_bfloat16*>(skip);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B, a.H = H, a.W = W, a.Cin = Cin, a.Cout = Cout, a.silu = silu, a.bias_rows = bias_rows;
  return launch_tiles_bn<true>(bn, x, w, a, grid, stream);
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
// pad 0: (0, 1) -> out [B, H/2, W/2, Cout]; bn and grid from the plan
// (ops/conv_fused.py `plan_down2`).
extern "C" int conv3x3_down2_bf16(const void* x, const void* w, const void* bias, void* out,
                                  int B, int H, int W, int Cin, int Cout, int silu, int pad,
                                  int bn, int grid, void* stream) {
  if (H % 2 || W % 2) return static_cast<int>(cudaErrorInvalidValue);
  TileArgs a{};
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B, a.H = H, a.W = W, a.Cin = Cin, a.Cout = Cout, a.silu = silu, a.bias_rows = 1;
  a.pad = pad;
  switch (bn) {
    case 64: return launch_down2<64>(x, w, a, grid, stream);
    case 80: return launch_down2<80>(x, w, a, grid, stream);
    case 128: return launch_down2<128>(x, w, a, grid, stream);
    case 160: return launch_down2<160>(x, w, a, grid, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
