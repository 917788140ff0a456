// Exact softmax attention with an online softmax (flash attention), bf16
// in and out, fp32 statistics and accumulator, BSHD layout read through
// strides (no transpose copy).
//
// Replaces both TPU kernels of fastedit_tpu/ops/flash_attention.py:
//   * `_flash_packed` / `_packed_kernel`, which packs two 64-dim heads into
//     the TPU's 128 lanes (UNet self-attention).  Head packing exists only
//     for the TPU's 128-wide matrix unit; here it is one head per tile.
//   * `_flash_bhsd` / `_flash_kernel` (one head per grid row, any D), used
//     for the VAE mid block's single 512-dim head.
// Semantics kept from the TPU kernels: the scale is folded into q in q's
// dtype (bf16 product), running max / sum / output accumulate in fp32,
// P is rounded to bf16 before P.V, the sum uses the unrounded P.
//
// What bounds it on an H100: operations, of two kinds.  4*Sq*Skv*D FLOPs
// against 2*(Sq+Skv)*D*2 bytes per head is thousands of FLOPs per byte at
// S >= 1024, far above the bf16 ridge point (~295 FLOP/byte), and the scores
// never touch HBM (the plain version writes an Sq x Skv fp32 matrix per
// head).  At D = 64 the softmax is a second limit of the same size: one exp
// per 4*D = 256 FLOPs, and an SM evaluates 16 a clock, so the exps of a call
// take about as long as its multiplies at the tensor cores' peak.  They have
// to run under the multiplies, not between them.
//
// D = 64, `flash_d64_kernel` (the UNet's 34 self-attention calls per
// forward), written for Hopper; its schedule is decided by the host
// (ops/flash_attention.py `plan`) and arrives as ints:
//   * A tile is 128 or 192 q rows of one (batch, head): 64 for each of two
//     or three consumer warpgroups (`flash_d64_kernel<NWG>`; the plan picks
//     the instance that needs the cheaper rounds of tiles on the card's SMs).
//     Sq is a multiple of 64, not of the tile: the rows of a head's last tile
//     that lie past Sq are zero-filled by the load and clipped by the store,
//     and their warpgroups run along on zeros.  The block is persistent and
//     warp-specialised: warp 0 is the producer, one thread of which issues
//     TMA loads over 4-D tensor maps (d, head, row, batch) with box
//     (64, 1, rows, 1), so a tile never straddles a head and q, k and v are
//     read through their strides: Q into a ring of 2 tiles, K and V into
//     rings of 4 tiles of 128 keys each, completion reported to "full"
//     mbarriers.  The consumer warpgroups wait on them and arrive on the
//     "empty" mbarriers once the wgmma group that read a stage has retired.
//     No __syncthreads() after set-up.  setmaxnreg moves the producer
//     warpgroup's registers to the consumers (232 each of two, 160 of three).
//   * S = Q K^T is wgmma m64n128k16, both operands through descriptors (a
//     row of Q or K is one 128-byte swizzle row); O += P V is m64n64k16 with
//     P from the registers S was computed in (the accumulator layout is the
//     A-fragment layout) and V, whose rows are keys while the contraction
//     runs over keys, as the MN-major B operand (the transpose bit).
//   * The exps run under the multiplies.  Inside a warpgroup, S(j+1) =
//     Q K(j+1)^T and O += P(j) V(j) are issued before the softmax of S(j+1)
//     starts, so that softmax runs while the tensor cores work on P(j) V(j);
//     P(j)'s registers are rewritten only after that group has retired.  And
//     the warpgroups issue their products in turns (a ring of named barriers:
//     each waits at its own until the one before it has issued), so that
//     one's softmax runs under the others' products and they meet less at the
//     exp unit; measured 5-8% over letting them run free.  exp(s - m) is one
//     FFMA and one ex2.approx: ex2(s * log2(e) - m * log2(e)).
//   * The scale is folded into Q by the consumers, each on its own 64 rows of
//     the landed tile, in bf16 (q * bf16(scale)), then fence.proxy.async.
//   * O / l is rounded to bf16 once, staged in the warpgroup's slice of the Q
//     stage it has finished with (swizzled, conflict-free) and written by one
//     TMA store; the Q stage is released when every store has read it.
//   * Tiles are walked q tile fastest, so the blocks that run together share
//     a head's K and V in L2 (heads fastest measured the same: the K and V of
//     a whole call fit the card's L2).
//
// D = 64 with every key in one tile, `flash_d64_kernel_cross<NWG, BKV>` (the
// UNet's cross-attention to the 77 text tokens: 34 calls a forward in SSD-1B,
// 70 in SDXL).  It replaces no Pallas kernel: the JAX package sends these calls
// to XLA (`attention_xla`, fastedit_tpu/ops/attention.py), as the flash
// kernels' gate wants 128 keys or more.  What bounds it on an H100: bytes.  Per
// q row it reads 128 bytes and writes 128, and does 4 * 77 * 64 FLOPs: ~77
// FLOPs a byte, a quarter of the ridge point, and one exp per 256 FLOPs as in
// flash_d64_kernel.  So the design moves q once in and O once out and keeps
// everything else on the chip: K and V come from L2 (1.6 MB for a whole call
// at 8 rows), S and P never leave registers, and rings of four Q and four K /
// V tiles and the TMA store keep loads and stores in flight under the products
// and the softmax.  The walk's order is the larger lever: heads fastest, the
// blocks' loads meet whole rows of q at once, 72.7% of 3.35 TB/s at [8, 4096,
// 10, 64] with L2 cold, against 58-60% for each block on a contiguous range of
// a head's tiles that loaded K and V once a head (H100 80GB HBM3, 700 W,
// tools/variants_flash_cross.py).  With all keys in one tile the softmax
// needs no running max: the max and the sum are exact in one pass, so P is
// normalised in fp32 before it is rounded to bf16, where the plain version
// rounds it.  The KV tile is 80 keys for Skv <= 80 (a wgmma of N = 80: 5 of 8
// parts of the 128-key tile's products and exps), 128 up to 127 keys.
//
// D = 512, `flash_d512_kernel` (the VAE mid block's single head over a 128 x
// 128 latent: two calls per edit, Sq = Skv = 16384), written for Hopper on the
// same parts (tensor maps read through the strides, mbarrier rings,
// persistent blocks, q tile fastest); schedule again from `plan`:
//   * O does not fit one warpgroup: 64 rows x 512 columns in fp32 are 256
//     registers a thread.  So D is split: two "PV" warpgroups own 256 columns
//     of O each (128 accumulator registers; m64n256k16, V the MN-major B
//     operand over four column panels, the descriptor's leading offset from
//     panel to panel) for the same 64 q rows, and S is computed once, by a
//     third, the "softmax" warpgroup: S = Q K^T for a KV tile of 64 keys
//     (m64n64k16, 32 k steps across D), the online softmax in its registers,
//     then P (bf16, in the swizzled K-major layout wgmma reads as A) and the
//     rows' rescale factors through shared memory to the other two, two
//     buffers deep, "full" and "empty" mbarriers either way; the row sums go
//     the same way at the end of a tile, as 1 / l.  The softmax is 1/8 of
//     D = 64's per FLOP (one exp per 2048 FLOPs), so one warpgroup keeps up
//     with it while the other two multiply.
//   * Twelve warps and no producer warp.  ptxas budgets the whole kernel by
//     its launch bounds, whatever setmaxnreg says later: m64n256k16 with 128
//     accumulators needs 154 registers to compile, twelve warps may have 168
//     and a thirteenth leaves 128.  So every warpgroup loads what it
//     consumes: the softmax warpgroup Q and K, a PV warpgroup its columns of
//     V.  All its threads wait for the stage to be free and one issues the
//     TMA load under a predicate, a ring's depth ahead.
//   * Every wgmma group has its own wgmma.fence right before it, after the
//     wait for its operands.  With one fence for a whole KV tile ptxas put
//     its own behind each wait's loop and then serialised every wgmma of the
//     kernel (C7520: a wait after each HGMMA, 293 instead of 400 TFLOP/s).
//   * D = 512 is eight 128-byte swizzle rows, so every tile is eight column
//     panels of 64 elements.  A 5-D tensor map (column within a panel, row,
//     panel, head, batch) lands a box panel by panel, rows 128 bytes apart,
//     in one load: Q (64 rows x 8 panels, 64 KB, one stage), K in a ring of
//     six panels of 64 keys x 64 columns (8 KB; the contraction of Q K^T walks
//     the panels in order and hands each back when the wgmma group that read
//     it has retired, so K streams through 48 KB), V per PV warpgroup in a
//     ring of six slabs of 16 keys x its 256 columns (8 KB: one k step, handed
//     back when its wgmma has retired; 1.25 KV tiles are on their way ahead of
//     it).  Q 64 + K 48 + V 96 + P 16 KB: 231,248 bytes with the barriers, of
//     the 232,448 a block may have.  (Stages twice as large and half as many
//     measured 20% slower; eight of K and five of V, or ten and four, the
//     same.)  The k steps of S alternate over two accumulators.
//   * O / l is rounded once, staged over Q's panels (swizzled) and written by
//     four TMA stores a PV warpgroup; the Q stage is released when both have
//     read it out.
//   * What bounds it: the block itself, not what blocks share (half as many
//     blocks take twice as long).  clock64() in an instrumented copy: a KV
//     tile takes ~4700 clocks where its multiplies need 2048 at the tensor
//     cores' peak.  The softmax warpgroup spends 3800-4000 of them in S (32
//     wgmmas of N = 64, ~120 clocks each where 32 would do), ~470 in the
//     softmax and ~220 handing P over; a PV warpgroup waits 1800-2100 for P,
//     rescales for 320 and multiplies for 1850-2000.  S is not held by its
//     accumulator (two or four alternating accumulators: 3-4%; two stay), not
//     by the loads (without any TMA load: 16%), and not by the tensor cores
//     standing idle under the softmax (the first half of S(j + 1) issued
//     before softmax(j): no gain): wgmmas of N = 64 with both operands from
//     shared memory, which they read at the rate it can give, share it and
//     the tensor cores with the PV warpgroups' wgmmas of N = 256.  A KV tile
//     of 128 keys (N = 128 for S) needs 32 KB more than a block has.  A q
//     tile of 128 rows would halve the L2 traffic (a 64-row tile rereads all
//     of K and V: 8.6 GB a call) but its O would fill the whole register file.

#include "hopper.cuh"

namespace {

using namespace hopper;

// Two fp32 values as one bf16x2 register, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// volatile: the compiler keeps volatile asm statements in program order, so an
// exp written before a wgmma wait is issued before it.  Without it the wait
// for P V was hoisted above the exps it should have covered (read in the SASS).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

namespace d64 {
constexpr int D = 64, BKV = 128;
constexpr int SLICE = 64;                     // q rows of one consumer warpgroup: one wgmma M
constexpr int Q_STAGES = 2, KV_STAGES = 4;
constexpr int KV_BYTES = BKV * D * 2;         // one K or V tile: 128 rows of 128 bytes
constexpr int SLICE_BYTES = SLICE * D * 2;    // one warpgroup's rows of Q (then O)
constexpr float LOG2E = 1.4426950408889634f;
// NWG consumer warpgroups, so a q tile of 64 NWG rows, beside the producer's.
__host__ __device__ constexpr int q_bytes(int nwg) { return nwg * SLICE_BYTES; }
__host__ __device__ constexpr int threads(int nwg) { return 128 * (nwg + 1); }
__host__ __device__ constexpr int smem_bytes(int nwg) {
  return 1024 + Q_STAGES * q_bytes(nwg) + 2 * KV_STAGES * KV_BYTES +
         8 * (2 * Q_STAGES + 4 * KV_STAGES);
}
}  // namespace d64

struct WalkArgs {
  int H, Skv;
  int q_tiles, tiles;  // q tiles per head; all tiles: B * H * q_tiles
  float scale;
};

template <int NWG>
__global__ void __launch_bounds__(d64::threads(NWG), 1)
flash_d64_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_o, const WalkArgs p) {
  using namespace d64;
  constexpr int BQ = NWG * SLICE, Q_BYTES = q_bytes(NWG);
  // Registers a thread: 65536 / threads at launch; the producer warpgroup
  // keeps few and each consumer warpgroup takes an equal share of the rest.
  constexpr int PRODUCER_REGS = NWG == 2 ? 40 : 32, CONSUMER_REGS = NWG == 2 ? 232 : 160;
  static_assert(PRODUCER_REGS + NWG * CONSUMER_REGS <= 512, "the SM has 64 K registers");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_smem = q_smem + Q_STAGES * Q_BYTES;
  const uint32_t v_smem = k_smem + KV_STAGES * KV_BYTES;
  const uint32_t bars = v_smem + KV_STAGES * KV_BYTES;
  auto full_q = [&](int s) { return bars + 8 * s; };
  auto empty_q = [&](int s) { return bars + 8 * (Q_STAGES + s); };
  auto full_k = [&](int s) { return bars + 8 * (2 * Q_STAGES + s); };
  auto empty_k = [&](int s) { return bars + 8 * (2 * Q_STAGES + KV_STAGES + s); };
  auto full_v = [&](int s) { return bars + 8 * (2 * Q_STAGES + 2 * KV_STAGES + s); };
  auto empty_v = [&](int s) { return bars + 8 * (2 * Q_STAGES + 3 * KV_STAGES + s); };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kv_tiles = p.Skv / BKV;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Q_STAGES; ++s) {
      mbar_init(full_q(s), 1);   // the producer's expect_tx
      mbar_init(empty_q(s), NWG);  // the thread of each consumer warpgroup that stores O
    }
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(empty_k(s), 4 * NWG);  // lane 0 of every consumer warp
      mbar_init(full_v(s), 1);
      mbar_init(empty_v(s), 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tile t of the persistent walk -> (batch, head, first q row): q tile
  // fastest, then the head, then the batch.
  auto tile_at = [&](int t, int& b, int& h, int& q0) {
    const int bh = t / p.q_tiles;
    q0 = (t - bh * p.q_tiles) * BQ;
    b = bh / p.H;
    h = bh - b * p.H;
  };

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != 0) return;
    // Producer: per tile Q, then K(j), V(j) in the consumers' order.
    int qs = 0, qp = 0, ks = 0, kp = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      int b, h, q0;
      tile_at(t, b, h, q0);
      mbar_wait(empty_q(qs), qp ^ 1);
      mbar_expect_tx(full_q(qs), Q_BYTES);  // rows past Sq are zero-filled and counted
      tma_load_4d(q_smem + qs * Q_BYTES, &map_q, full_q(qs), 0, h, q0, b);
      if (++qs == Q_STAGES) qs = 0, qp ^= 1;
      for (int j = 0; j < kv_tiles; ++j) {
        mbar_wait(empty_k(ks), kp ^ 1);
        mbar_expect_tx(full_k(ks), KV_BYTES);
        tma_load_4d(k_smem + ks * KV_BYTES, &map_k, full_k(ks), 0, h, j * BKV, b);
        mbar_wait(empty_v(ks), kp ^ 1);
        mbar_expect_tx(full_v(ks), KV_BYTES);
        tma_load_4d(v_smem + ks * KV_BYTES, &map_v, full_v(ks), 0, h, j * BKV, b);
        if (++ks == KV_STAGES) ks = 0, kp ^= 1;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    // Consumers: warpgroup cw owns q rows 64cw .. 64cw+63 of the tile; thread
    // (w, lane) holds rows 16w + lane/4 and + 8 of them.  A tile's last
    // warpgroups may lie past Sq (Sq is a multiple of 64, not of the tile):
    // their Q is TMA's zero fill and their store is clipped by the tensor
    // map, so they run along on zeros and write nothing.
    const int cw = (warp >> 2) - 1, w = warp & 3;
    const int tid = threadIdx.x & 127;
    const __nv_bfloat162 scale2 = __float2bfloat162_rn(p.scale);
    int qs = 0, qp = 0, ks = 0, kp = 0, vs = 0, vp = 0;
    float s[BKV / 2];   // S, then the unrounded P, of this thread's two rows
    float o[D / 2];
    uint32_t pa[BKV / 4];  // P in bf16: the A fragments of the BKV / 16 k steps
    float m_run[2] = {-1e30f, -1e30f}, l_part[2] = {0.f, 0.f};

    // S = Q K(ks)^T, one wgmma group.
    auto issue_s = [&](uint32_t q_half) {
      mbar_wait(full_k(ks), kp);
      const uint64_t dq = smem_desc(q_half), dk = smem_desc(k_smem + ks * KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
      wgmma_commit();
    };
    // O += P V(vs), one wgmma group.
    auto issue_pv = [&]() {
      mbar_wait(full_v(vs), vp);
      const uint64_t dv = smem_desc(v_smem + vs * KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_rs_tb(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3], dv + 128 * kk);
      wgmma_commit();
    };
    auto release_k = [&]() {
      if (lane == 0) mbar_arrive(empty_k(ks));
      if (++ks == KV_STAGES) ks = 0, kp ^= 1;
    };
    auto release_v = [&]() {
      if (lane == 0) mbar_arrive(empty_v(vs));
      if (++vs == KV_STAGES) vs = 0, vp ^= 1;
    };
    // Online softmax of S in place: s becomes the unrounded P, the running
    // max and the partial sums move on; returns nothing, alpha by reference.
    auto softmax = [&](float (&alpha)[2]) {
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      float neg[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = ex2((m_run[r] - mx[r]) * LOG2E);
        m_run[r] = mx[r];
        neg[r] = -mx[r] * LOG2E;
        l_part[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = ex2(fmaf(s[4 * j + e], LOG2E, neg[e >> 1]));
          l_part[e >> 1] += pe;
          s[4 * j + e] = pe;
        }
      }
    };
    // In turns: a warpgroup issues its products only after the one before it
    // has issued its own.  A warp that issues a wgmma waits at it while the
    // tensor cores are busy, so a warpgroup's products and its softmax do not
    // overlap each other: they overlap the other warpgroups', and the turns
    // keep those apart.  Barrier 4 + cw belongs to warpgroup cw: it waits
    // there, the warpgroup before it arrives there.
    auto turn_wait = [&]() {
      asm volatile("bar.sync %0, 256;\n" ::"r"(4 + cw) : "memory");
    };
    auto turn_pass = [&]() {
      asm volatile("bar.arrive %0, 256;\n" ::"r"(4 + (cw + 1) % NWG) : "memory");
    };
    if (cw == NWG - 1) turn_pass();  // warpgroup 0 goes first
    auto pack_p = [&]() {
#pragma unroll
      for (int i = 0; i < BKV / 4; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    };

    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      int b, h, q0;
      tile_at(t, b, h, q0);
      const uint32_t q_half = q_smem + qs * Q_BYTES + cw * SLICE_BYTES;
      mbar_wait(full_q(qs), qp);
      // q * bf16(scale) on this warpgroup's 64 rows, 16 bytes a thread and pass.
#pragma unroll
      for (int i = 0; i < SLICE_BYTES / (128 * 16); ++i) {
        const uint32_t addr = q_half + (i * 128 + tid) * 16;
        uint32_t r[4];
        asm volatile("ld.shared.v4.u32 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                     : "r"(addr)
                     : "memory");
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 v = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&r[e]), scale2);
          r[e] = *reinterpret_cast<const uint32_t*>(&v);
        }
        asm volatile("st.shared.v4.u32 [%0], {%1,%2,%3,%4};\n" ::"r"(addr), "r"(r[0]), "r"(r[1]),
                     "r"(r[2]), "r"(r[3])
                     : "memory");
      }
      fence_async_shared();
      named_barrier(1 + cw, 128);

#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      m_run[0] = m_run[1] = -1e30f;
      l_part[0] = l_part[1] = 0.f;
      float alpha[2];

      turn_wait();
      wgmma_fence();
      issue_s(q_half);
      turn_pass();
      wgmma_wait<0>();
      release_k();
      softmax(alpha);
      pack_p();
      for (int j = 1; j < kv_tiles; ++j) {
        turn_wait();
        wgmma_fence();
        issue_s(q_half);   // S(j)
        issue_pv();        // O += P(j-1) V(j-1)
        turn_pass();
        wgmma_wait<1>();   // S(j) is there
        release_k();
        softmax(alpha);    // under P(j-1) V(j-1)
        wgmma_wait<0>();   // O is there; P(j-1)'s registers are free
        release_v();
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          o[4 * i] *= alpha[0];
          o[4 * i + 1] *= alpha[0];
          o[4 * i + 2] *= alpha[1];
          o[4 * i + 3] *= alpha[1];
        }
        pack_p();
      }
      wgmma_fence();
      issue_pv();
      wgmma_wait<0>();
      release_v();

      // O / l, one rounding, into this warpgroup's half of the Q stage (its
      // last reader, S of the last kv tile, has retired), then one TMA store.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_part[r] += __shfl_xor_sync(0xffffffffu, l_part[r], 1);
        l_part[r] += __shfl_xor_sync(0xffffffffu, l_part[r], 2);
        l_part[r] = 1.f / l_part[r];
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 16 * w + (lane >> 2) + 8 * half;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const uint32_t v = pack_bf16(o[4 * j + 2 * half] * l_part[half],
                                       o[4 * j + 2 * half + 1] * l_part[half]);
          const uint32_t addr = q_half + row * 128 + ((j ^ (row & 7)) << 4) + (lane & 3) * 4;
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
        }
      }
      fence_async_shared();
      named_barrier(1 + cw, 128);
      if (tid == 0) {
        tma_store_4d(&map_o, q_half, 0, h, q0 + SLICE * cw, b);  // clipped past Sq
        tma_store_wait_read();
        mbar_arrive(empty_q(qs));
      }
      if (++qs == Q_STAGES) qs = 0, qp ^= 1;
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

namespace cross {
constexpr int Q_STAGES = 4, KV_STAGES = 4;
__host__ __device__ constexpr int kv_bytes(int bkv) { return bkv * d64::D * 2; }
__host__ __device__ constexpr int smem_bytes(int nwg, int bkv) {
  return 1024 + Q_STAGES * d64::q_bytes(nwg) + 2 * KV_STAGES * kv_bytes(bkv) +
         8 * 2 * (Q_STAGES + KV_STAGES);
}
}  // namespace cross

// Cross-attention to a short key sequence (the UNet's 77 text tokens), D = 64,
// every key in one KV tile of BKV = 80 or 128 keys: `flash_d64_kernel_cross`.
// A tile is 64 NWG q rows of one (batch, head), as in flash_d64_kernel, and
// the persistent blocks walk the tiles heads fastest, strided by the grid, so
// that the blocks running together read whole rows of q (a tile reads 128
// bytes of each of its rows, whose heads lie side by side).  A producer warp
// keeps a ring of four Q tiles full and loads each tile's K and V (10 KB each
// at 80 keys, L2-resident; rows past Skv are TMA's zero fill) into a ring of
// four beside it, unless the tile's head is the previous tile's.  Per tile a
// consumer warpgroup computes S = Q K^T (m64nBKVk16, fp32), sets the key columns at or
// past Skv to -inf, takes the row max and the sum of exp(scale (s - max))
// exactly in one pass, normalises P by that sum in fp32 and rounds it to bf16
// once (the plain version's order), multiplies O = P V from registers and
// rounds O once; the store goes through the warpgroup's slice of the Q stage
// by TMA, so one tile's store and the next tiles' loads overlap the product.
template <int NWG, int BKV>
__global__ void __launch_bounds__(d64::threads(NWG), 1)
flash_d64_kernel_cross(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_o, const WalkArgs p) {
  using namespace d64;
  using cross::KV_STAGES;
  using cross::Q_STAGES;
  static_assert(BKV % 16 == 0 && BKV <= 128, "one KV tile of whole k steps, one wgmma N");
  constexpr int BQ = NWG * SLICE, Q_BYTES = q_bytes(NWG), KV_BYTES = cross::kv_bytes(BKV);
  constexpr int PRODUCER_REGS = NWG == 2 ? 40 : 32, CONSUMER_REGS = NWG == 2 ? 232 : 160;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_smem = q_smem + Q_STAGES * Q_BYTES;
  const uint32_t v_smem = k_smem + KV_STAGES * KV_BYTES;
  const uint32_t bars = v_smem + KV_STAGES * KV_BYTES;
  auto full_q = [&](int s) { return bars + 8 * s; };
  auto empty_q = [&](int s) { return bars + 8 * (Q_STAGES + s); };
  auto full_kv = [&](int s) { return bars + 8 * (2 * Q_STAGES + s); };
  auto empty_kv = [&](int s) { return bars + 8 * (2 * Q_STAGES + KV_STAGES + s); };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Q_STAGES; ++s) {
      mbar_init(full_q(s), 1);     // the producer's expect_tx
      mbar_init(empty_q(s), NWG);  // the thread of each consumer warpgroup that stores O
    }
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(full_kv(s), 1);
      mbar_init(empty_kv(s), 4 * NWG);  // lane 0 of every consumer warp, after the stage's tiles
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tile t -> (batch, head, first q row): the head fastest, then the q tile,
  // then the batch.  Block i walks tiles i, i + grid, ...
  auto tile_at = [&](int t, int& bh, int& b, int& h, int& q0) {
    h = t % p.H;
    q0 = (t / p.H % p.q_tiles) * BQ;
    b = t / p.H / p.q_tiles;
    bh = b * p.H + h;
  };

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != 0) return;
    // Producer: a tile's K and V where its head is not the previous tile's,
    // then its Q.
    int qs = 0, qp = 0, kvs = 0, kvp = 0, held = -1;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      int bh, b, h, q0;
      tile_at(t, bh, b, h, q0);
      if (bh != held) {
        if (held >= 0 && ++kvs == KV_STAGES) kvs = 0, kvp ^= 1;
        held = bh;
        mbar_wait(empty_kv(kvs), kvp ^ 1);
        mbar_expect_tx(full_kv(kvs), 2 * KV_BYTES);  // keys past Skv are zero-filled and counted
        tma_load_4d(k_smem + kvs * KV_BYTES, &map_k, full_kv(kvs), 0, h, 0, b);
        tma_load_4d(v_smem + kvs * KV_BYTES, &map_v, full_kv(kvs), 0, h, 0, b);
      }
      mbar_wait(empty_q(qs), qp ^ 1);
      mbar_expect_tx(full_q(qs), Q_BYTES);  // rows past Sq are zero-filled and counted
      tma_load_4d(q_smem + qs * Q_BYTES, &map_q, full_q(qs), 0, h, q0, b);
      if (++qs == Q_STAGES) qs = 0, qp ^= 1;
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    // Warpgroup cw owns q rows 64cw .. 64cw+63 of a tile; thread (w, lane)
    // holds rows 16w + lane/4 and + 8, key columns 8j + 2(lane%4), + 1 of them
    // in s[4j .. 4j+3].  Rows past Sq run along on TMA's zeros and their
    // store is clipped by the tensor map.
    const int cw = (warp >> 2) - 1, w = warp & 3;
    const int tid = threadIdx.x & 127;
    const float scale_log2 = p.scale * LOG2E, neg_inf = __int_as_float(0xff800000);
    int qs = 0, qp = 0, kvs = 0, kvp = 0, held = -1;
    float s[BKV / 2];      // S, then P, of this thread's two rows
    float o[D / 2];
    uint32_t pa[BKV / 4];  // P in bf16: the A fragments of the BKV / 16 k steps

    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      int bh, b, h, q0;
      tile_at(t, bh, b, h, q0);
      if (bh != held) {
        if (held >= 0 && ++kvs == KV_STAGES) kvs = 0, kvp ^= 1;
        held = bh;
      }
      const uint32_t q_half = q_smem + qs * Q_BYTES + cw * SLICE_BYTES;
      mbar_wait(full_q(qs), qp);
      mbar_wait(full_kv(kvs), kvp);

      // S = Q K^T, fp32.
      wgmma_fence();
      {
        const uint64_t dq = smem_desc(q_half), dk = smem_desc(k_smem + kvs * KV_BYTES);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();

      // The softmax of each row over its Skv keys, in one pass: the padded
      // keys to -inf, the exact max and sum, P = exp(scale (s - max)) / sum in
      // fp32, then rounded to bf16.
      float mx[2] = {neg_inf, neg_inf};
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (8 * j + 2 * (lane & 3) + (e & 1) >= p.Skv) s[4 * j + e] = neg_inf;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
        }
      }
      float neg[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        neg[r] = -mx[r] * scale_log2;
      }
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        s[i] = ex2(fmaf(s[i], scale_log2, neg[(i >> 1) & 1]));  // exp2(-inf) = 0
        sum[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        sum[r] = 1.f / sum[r];
      }
#pragma unroll
      for (int i = 0; i < BKV / 4; ++i)
        pa[i] = pack_bf16(s[2 * i] * sum[i & 1], s[2 * i + 1] * sum[i & 1]);

      // O = P V: V's rows are keys, the MN-major B operand; padded keys are
      // zero in V and in P.
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      wgmma_fence();
      {
        const uint64_t dv = smem_desc(v_smem + kvs * KV_BYTES);
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
          wgmma_rs_tb(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                      dv + 128 * kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      const int next = t + gridDim.x;  // K and V stay for the next tile of the same head
      if (lane == 0 && (next >= p.tiles || next / p.H / p.q_tiles * p.H + next % p.H != bh))
        mbar_arrive(empty_kv(kvs));

      // O, rounded once, into this warpgroup's slice of the Q stage (S, its
      // last reader, has retired), then one TMA store.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 16 * w + (lane >> 2) + 8 * half;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const uint32_t v = pack_bf16(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
          const uint32_t addr = q_half + row * 128 + ((j ^ (row & 7)) << 4) + (lane & 3) * 4;
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
        }
      }
      fence_async_shared();
      named_barrier(1 + cw, 128);
      if (tid == 0) {
        tma_store_4d(&map_o, q_half, 0, h, q0 + SLICE * cw, b);  // clipped past Sq
        tma_store_wait_read();
        mbar_arrive(empty_q(qs));
      }
      if (++qs == Q_STAGES) qs = 0, qp ^= 1;
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

namespace d512 {
constexpr int D = 512, BQ = 64, BKV = 64;
constexpr int PANELS = D / 64;                     // column panels: one 128-byte swizzle row each
constexpr int Q_PANEL_BYTES = BQ * 128;
constexpr int Q_BYTES = PANELS * Q_PANEL_BYTES;    // 64 KB, one stage
constexpr int K_STAGES = 6;                        // ring of K panels: 64 keys x 64 columns
constexpr int K_STAGE_BYTES = BKV * 128;
constexpr int PV_GROUPS = 2;                       // PV warpgroups: D / 2 columns of O each
constexpr int COLS = D / PV_GROUPS;
constexpr int V_ROWS = 16, V_STAGES = 6;           // per PV warpgroup a ring of V slabs: 16 keys
constexpr int V_PANEL_BYTES = V_ROWS * 128;        //   x its 256 columns, panel by panel
constexpr int V_STAGE_BYTES = (COLS / 64) * V_PANEL_BYTES;
constexpr int S_CHAINS = 2;                        // accumulators the k steps of S alternate over
constexpr int P_STAGES = 2;                        // P (bf16, one swizzle panel) and a row statistic
constexpr int P_BYTES = BQ * BKV * 2;
constexpr int STAT_BYTES = BQ * 4;
constexpr int THREADS = 128 * (1 + PV_GROUPS);     // the softmax warpgroup and the PV warpgroups
constexpr int N_BARS = 2 + 2 * K_STAGES + 2 * PV_GROUPS * V_STAGES + 2 * P_STAGES;
constexpr int SMEM_BYTES = 1024 + Q_BYTES + K_STAGES * K_STAGE_BYTES +
                           PV_GROUPS * V_STAGES * V_STAGE_BYTES +
                           P_STAGES * (P_BYTES + STAT_BYTES) + 8 * N_BARS;
static_assert(BKV * 2 == 128, "P is one swizzle panel: a row of 64 keys is 128 bytes");
static_assert(COLS == 256, "a PV warpgroup's product is m64n256k16");
}  // namespace d512

__global__ void __launch_bounds__(d512::THREADS, 1)
flash_d512_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const __grid_constant__ CUtensorMap map_o, const WalkArgs p) {
  using namespace d512;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_smem = q_smem + Q_BYTES;
  const uint32_t v_smem = k_smem + K_STAGES * K_STAGE_BYTES;
  const uint32_t p_smem = v_smem + PV_GROUPS * V_STAGES * V_STAGE_BYTES;
  const uint32_t stat_smem = p_smem + P_STAGES * P_BYTES;
  const uint32_t bars = stat_smem + P_STAGES * STAT_BYTES;
  const uint32_t full_q = bars, empty_q = bars + 8;
  auto full_k = [&](int s) { return bars + 8 * (2 + s); };
  auto empty_k = [&](int s) { return bars + 8 * (2 + K_STAGES + s); };
  // s: stage of PV warpgroup g's ring, g * V_STAGES + stage
  auto full_v = [&](int s) { return bars + 8 * (2 + 2 * K_STAGES + s); };
  auto empty_v = [&](int s) { return bars + 8 * (2 + 2 * K_STAGES + PV_GROUPS * V_STAGES + s); };
  auto full_p = [&](int s) { return bars + 8 * (2 + 2 * K_STAGES + 2 * PV_GROUPS * V_STAGES + s); };
  auto empty_p = [&](int s) {
    return bars + 8 * (2 + 2 * K_STAGES + 2 * PV_GROUPS * V_STAGES + P_STAGES + s);
  };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tid = threadIdx.x & 127;
  const int loader = tid == 0;  // the thread of a warpgroup that issues its loads
  const int kv_tiles = p.Skv / BKV;
  // Thread (w, lane) of a warpgroup holds rows 16w + lane / 4 and + 8 of a
  // wgmma result, columns 8g + 2(lane % 4), + 1 of them in d[4g .. 4g + 3].
  const int row = 16 * (warp & 3) + (lane >> 2), quad = lane & 3;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);           // the loader's expect_tx
    mbar_init(empty_q, PV_GROUPS);  // the thread of each PV warpgroup that stores O
    for (int s = 0; s < K_STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(empty_k(s), 4);  // lane 0 of every softmax warp
    }
    for (int s = 0; s < PV_GROUPS * V_STAGES; ++s) {
      mbar_init(full_v(s), 1);
      mbar_init(empty_v(s), 4);  // lane 0 of every warp of the ring's warpgroup
    }
    for (int s = 0; s < P_STAGES; ++s) {
      mbar_init(full_p(s), 128);             // every softmax thread, after its own writes
      mbar_init(empty_p(s), 4 * PV_GROUPS);  // lane 0 of every PV warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tile t of the persistent walk -> (batch, head, first q row), q tile fastest.
  auto tile_at = [&](int t, int& b, int& h, int& q0) {
    const int bh = t / p.q_tiles;
    q0 = (t - bh * p.q_tiles) * BQ;
    b = bh / p.H;
    h = bh - b * p.H;
  };
  // Where a warpgroup's loads stand in its ring: the stage and the phase to
  // load next, and the (tile, row, panel) that goes there.  Every thread of
  // the warpgroup keeps it (the values do not depend on the thread).  It runs
  // on from tile to tile, so the next tile's first loads are under way while
  // this one ends.
  int ld_s = 0, ld_ph = 0, ld_t = blockIdx.x, ld_row = 0, ld_pn = 0, ld_b = 0, ld_h = 0, ld_q0 = 0;
  if (ld_t < p.tiles) tile_at(ld_t, ld_b, ld_h, ld_q0);
  auto ld_next_rows = [&](int rows) {
    ld_row += rows;
    if (ld_row == p.Skv) {
      ld_row = 0;
      ld_t += gridDim.x;
      if (ld_t < p.tiles) tile_at(ld_t, ld_b, ld_h, ld_q0);
    }
  };

  if (warp < 4) {
    // The softmax warpgroup: S = Q K^T of a KV tile, the online softmax, then
    // P and the rows' rescale factors to the PV warpgroups.  It loads Q and
    // the K panels.
    auto load_k = [&]() {  // the next panel of K, into the stage its turn has come to
      if (ld_t >= p.tiles) return;
      mbar_wait(empty_k(ld_s), ld_ph ^ 1);
      mbar_expect_tx_if(loader, full_k(ld_s), K_STAGE_BYTES);
      tma_load_5d_if(loader, k_smem + ld_s * K_STAGE_BYTES, &map_k, full_k(ld_s), 0, ld_row,
                     ld_pn, ld_h, ld_b);
      if (++ld_s == K_STAGES) ld_s = 0, ld_ph ^= 1;
      if (++ld_pn == PANELS) ld_pn = 0, ld_next_rows(BKV);
    };
    for (int i = 0; i < K_STAGES - 1; ++i) load_k();

    const __nv_bfloat162 scale2 = __float2bfloat162_rn(p.scale);
    int qp = 0, ks = 0, kp = 0;
    unsigned msg = 0;  // messages sent: buffer msg & 1, its phase (msg >> 1) & 1
    // S, then the unrounded P, in s[0].  The k steps of Q K^T alternate over
    // S_CHAINS accumulators, summed at the end (3-4% over one chain, in turns
    // in one run).
    float s[S_CHAINS][BKV / 2];
    // Wait until the PV warpgroups have read the buffer's previous message.
    auto claim = [&]() {
      mbar_wait(empty_p(msg & 1), ((msg >> 1) & 1) ^ 1);
      return static_cast<int>(msg & 1);
    };
    auto send = [&](int buf, float stat0, float stat1) {
      if (quad == 0) {
        const uint32_t addr = stat_smem + buf * STAT_BYTES + row * 4;
        asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(stat0) : "memory");
        asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr + 32), "f"(stat1) : "memory");
      }
      fence_async_shared();  // wgmma reads P through the async proxy
      mbar_arrive(full_p(buf));
      ++msg;
    };
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      int b, h, q0;
      tile_at(t, b, h, q0);
      mbar_wait(empty_q, qp ^ 1);  // both PV warpgroups have stored the last tile's O
      mbar_expect_tx_if(loader, full_q, Q_BYTES);
      tma_load_5d_if(loader, q_smem, &map_q, full_q, 0, q0, 0, h, b);
      mbar_wait(full_q, qp);
      qp ^= 1;
      // q * bf16(scale) in place, 16 bytes a thread and pass.
#pragma unroll 4
      for (int i = 0; i < Q_BYTES / (128 * 16); ++i) {
        const uint32_t addr = q_smem + (i * 128 + tid) * 16;
        uint32_t r[4];
        asm volatile("ld.shared.v4.u32 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                     : "r"(addr)
                     : "memory");
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 v = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&r[e]), scale2);
          r[e] = *reinterpret_cast<const uint32_t*>(&v);
        }
        asm volatile("st.shared.v4.u32 [%0], {%1,%2,%3,%4};\n" ::"r"(addr), "r"(r[0]), "r"(r[1]),
                     "r"(r[2]), "r"(r[3])
                     : "memory");
      }
      fence_async_shared();
      named_barrier(1, 128);

      float m_run[2] = {-1e30f, -1e30f}, l_part[2] = {0.f, 0.f};
      for (int j = 0; j < kv_tiles; ++j) {
        // S = Q K(j)^T: one wgmma group per panel.  A panel is handed back
        // when the group after it has been issued and its own has retired;
        // the panel five further on is then loaded into the stage that was
        // handed back a step earlier.
        int prev = 0;
#pragma unroll
        for (int pn = 0; pn < PANELS; ++pn) {
          mbar_wait(full_k(ks), kp);
          const uint64_t dq = smem_desc(q_smem + pn * Q_PANEL_BYTES);
          const uint64_t dk = smem_desc(k_smem + ks * K_STAGE_BYTES);
          // After the wait's loop, before the group: without its own fence
          // here ptxas puts one in and serialises every wgmma (C7520).
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss(s[kk % S_CHAINS], dq + 2 * kk, dk + 2 * kk, 4 * pn + kk >= S_CHAINS);
          wgmma_commit();
          if (pn > 0) {
            wgmma_wait<1>();
            if (lane == 0) mbar_arrive(empty_k(prev));
            load_k();
          }
          prev = ks;
          if (++ks == K_STAGES) ks = 0, kp ^= 1;
        }
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty_k(prev));
        load_k();

        // Online softmax in place: s[0] becomes the unrounded P.
#pragma unroll
        for (int c = 1; c < S_CHAINS; ++c)
#pragma unroll
          for (int i = 0; i < BKV / 2; ++i) s[0][i] += s[c][i];
        float mx[2] = {m_run[0], m_run[1]}, alpha[2], neg[2];
#pragma unroll
        for (int g = 0; g < BKV / 8; ++g) {
          mx[0] = fmaxf(mx[0], fmaxf(s[0][4 * g], s[0][4 * g + 1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[0][4 * g + 2], s[0][4 * g + 3]));
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[r] = ex2((m_run[r] - mx[r]) * d64::LOG2E);
          m_run[r] = mx[r];
          neg[r] = -mx[r] * d64::LOG2E;
          l_part[r] *= alpha[r];
        }
#pragma unroll
        for (int g = 0; g < BKV / 8; ++g) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pe = ex2(fmaf(s[0][4 * g + e], d64::LOG2E, neg[e >> 1]));
            l_part[e >> 1] += pe;
            s[0][4 * g + e] = pe;
          }
        }
        // P in bf16, K-major in the 128-byte swizzle: row r, keys 8g + 2 quad,
        // + 1 in the 16-byte chunk g ^ (r & 7) of the row.
        const int buf = claim();
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t prow = p_smem + buf * P_BYTES + (row + 8 * half) * 128 + quad * 4;
#pragma unroll
          for (int g = 0; g < BKV / 8; ++g) {
            const uint32_t v = pack_bf16(s[0][4 * g + 2 * half], s[0][4 * g + 2 * half + 1]);
            asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(prow + ((g ^ (row & 7)) << 4)), "r"(v)
                         : "memory");
          }
        }
        send(buf, alpha[0], alpha[1]);
      }
      // The tile's last message: 1 / l.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_part[r] += __shfl_xor_sync(0xffffffffu, l_part[r], 1);
        l_part[r] += __shfl_xor_sync(0xffffffffu, l_part[r], 2);
      }
      send(claim(), 1.f / l_part[0], 1.f / l_part[1]);
    }
  } else {
    // The PV warpgroups: warpgroup wg owns columns 256wg .. 256wg + 255 of O
    // for all 64 rows, and loads those columns of V.
    const int wg = (warp >> 2) - 1;
    const uint32_t v_ring = v_smem + wg * V_STAGES * V_STAGE_BYTES;
    auto load_v = [&]() {  // the next slab of V: V_ROWS keys, this warpgroup's four panels
      if (ld_t >= p.tiles) return;
      const uint32_t full = full_v(wg * V_STAGES + ld_s);
      mbar_wait(empty_v(wg * V_STAGES + ld_s), ld_ph ^ 1);
      mbar_expect_tx_if(loader, full, V_STAGE_BYTES);
      tma_load_5d_if(loader, v_ring + ld_s * V_STAGE_BYTES, &map_v, full, 0, ld_row,
                     wg * (COLS / 64), ld_h, ld_b);
      if (++ld_s == V_STAGES) ld_s = 0, ld_ph ^= 1;
      ld_next_rows(V_ROWS);
    };
    for (int i = 0; i < V_STAGES - 1; ++i) load_v();

    int vs = 0, vp = 0;
    unsigned msg = 0;
    float o[COLS / 2];
    // The next message: wait for it, read this thread's two row statistics.
    auto receive = [&](float& stat0, float& stat1) {
      const int buf = msg & 1;
      mbar_wait(full_p(buf), (msg >> 1) & 1);
      const uint32_t addr = stat_smem + buf * STAT_BYTES + row * 4;
      asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(stat0) : "r"(addr) : "memory");
      asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(stat1) : "r"(addr + 32) : "memory");
      ++msg;
      return buf;
    };
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      int b, h, q0;
      tile_at(t, b, h, q0);
#pragma unroll
      for (int i = 0; i < COLS / 2; ++i) o[i] = 0.f;
      for (int j = 0; j < kv_tiles; ++j) {
        float a0, a1;
        const int buf = receive(a0, a1);
#pragma unroll
        for (int g = 0; g < COLS / 8; ++g) {
          o[4 * g] *= a0;
          o[4 * g + 1] *= a0;
          o[4 * g + 2] *= a1;
          o[4 * g + 3] *= a1;
        }
        // O += P V(j): a slab of 16 keys is one k step, one wgmma group; it is
        // handed back when that has retired, and the slab five further on is
        // then loaded into the stage handed back a step earlier.
        const uint64_t dp = smem_desc(p_smem + buf * P_BYTES);
        int prev = 0;
#pragma unroll
        for (int sl = 0; sl < BKV / V_ROWS; ++sl) {
          mbar_wait(full_v(wg * V_STAGES + vs), vp);
          const uint64_t dv = smem_desc(v_ring + vs * V_STAGE_BYTES, 1024, V_PANEL_BYTES);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < V_ROWS / 16; ++kk)
            wgmma_ss_tb(o, dp + 2 * (sl * (V_ROWS / 16) + kk), dv + 128 * kk);
          wgmma_commit();
          if (sl > 0) {
            wgmma_wait<1>();
            if (lane == 0) mbar_arrive(empty_v(wg * V_STAGES + prev));
            load_v();
          }
          prev = vs;
          if (++vs == V_STAGES) vs = 0, vp ^= 1;
        }
        wgmma_wait<0>();
        if (lane == 0) {
          mbar_arrive(empty_v(wg * V_STAGES + prev));
          mbar_arrive(empty_p(buf));
        }
        load_v();
      }
      float inv0, inv1;
      const int buf = receive(inv0, inv1);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_p(buf));

      // O / l, one rounding, over this warpgroup's four panels of the Q stage
      // (its last reader, S of the last KV tile, retired before the last P was
      // sent), then four TMA stores.
      const uint32_t o_smem = q_smem + wg * (COLS / 64) * Q_PANEL_BYTES;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float inv = half ? inv1 : inv0;
        const uint32_t orow = o_smem + (row + 8 * half) * 128 + quad * 4;
#pragma unroll
        for (int g = 0; g < COLS / 8; ++g) {
          const uint32_t v = pack_bf16(o[4 * g + 2 * half] * inv, o[4 * g + 2 * half + 1] * inv);
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(orow + (g >> 3) * Q_PANEL_BYTES +
                                                         (((g & 7) ^ (row & 7)) << 4)),
                       "r"(v)
                       : "memory");
        }
      }
      fence_async_shared();
      named_barrier(2 + wg, 128);
      if (tid == 0) {
        for (int pn = 0; pn < COLS / 64; ++pn)
          tma_store_4d(&map_o, o_smem + pn * Q_PANEL_BYTES, COLS * wg + 64 * pn, h, q0, b);
        tma_store_wait_read();
        mbar_arrive(empty_q);
      }
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// Tensor map over a BSHD tensor as (d, head, row, batch), read through its
// strides (in elements), with a box of 64 columns x `rows` rows of one head.
int encode_bshd(CUtensorMap* map, const void* base, int B, int S, int H, int D, long long sb,
                long long ss, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return encode_map(map, base, 4, dims, strides, box);
}

// The same tensor, D = 64 * panels columns wide, as (d within a panel, row,
// panel, head, batch): a box of `panels` panels x `rows` rows lands panel by
// panel, each panel's rows 128 bytes apart, which is what wgmma's descriptors
// address.
int encode_bshd_panels(CUtensorMap* map, const void* base, int B, int S, int H, int D,
                       long long sb, long long ss, int rows, int panels) {
  const cuuint64_t dims[5] = {64, (cuuint64_t)S, (cuuint64_t)D / 64, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[4] = {(cuuint64_t)ss * 2, 128, (cuuint64_t)D * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[5] = {64, (cuuint32_t)rows, (cuuint32_t)panels, 1, 1};
  return encode_map(map, base, 5, dims, strides, box);
}

// Raise the kernel's dynamic shared memory limit, once per device.
template <typename Kernel>
int configure(Kernel kernel, int smem, unsigned long long& configured) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!(configured >> (device & 63) & 1)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured |= 1ull << (device & 63);
  }
  return 0;
}

// The D = 512 launch: q, k and v through 5-D maps that land a tile panel by
// panel, the output through a 4-D one, a panel a store.
int launch_d512(const void* q, const void* k, const void* v, void* out, int B, int H, int Sq,
                int Skv, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                long long v_sb, long long v_ss, float scale, int grid, cudaStream_t stream) {
  using namespace d512;
  static unsigned long long configured = 0;
  int err = configure(flash_d512_kernel, SMEM_BYTES, configured);
  if (err != 0) return err;
  if (grid < 1 || Sq % BQ || Skv % BKV) return static_cast<int>(cudaErrorInvalidValue);
  WalkArgs a{};
  a.H = H, a.Skv = Skv, a.scale = scale;
  a.q_tiles = Sq / BQ;
  a.tiles = B * H * a.q_tiles;
  CUtensorMap map_q, map_k, map_v, map_o;
  err = encode_bshd_panels(&map_q, q, B, Sq, H, D, q_sb, q_ss, BQ, PANELS);
  if (err == 0) err = encode_bshd_panels(&map_k, k, B, Skv, H, D, k_sb, k_ss, BKV, 1);
  if (err == 0)
    err = encode_bshd_panels(&map_v, v, B, Skv, H, D, v_sb, v_ss, V_ROWS, COLS / 64);
  if (err == 0) err = encode_bshd(&map_o, out, B, Sq, H, D, (long long)Sq * H * D,
                                  (long long)H * D, BQ);
  if (err != 0) return err;
  flash_d512_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(map_q, map_k, map_v, map_o, a);
  return static_cast<int>(cudaGetLastError());
}

// The D = 64 launch: four tensor maps over (d, head, row, batch), read
// through the tensors' strides, then `grid` persistent blocks.
template <int NWG>
int launch_d64(const void* q, const void* k, const void* v, void* out, int B, int H, int Sq,
               int Skv, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
               long long v_sb, long long v_ss, float scale, int grid, cudaStream_t stream) {
  using namespace d64;
  constexpr int BQ = NWG * SLICE, SMEM_BYTES = smem_bytes(NWG);
  static unsigned long long configured = 0;
  int err = configure(flash_d64_kernel<NWG>, SMEM_BYTES, configured);
  if (err != 0) return err;
  WalkArgs a{};
  a.H = H, a.Skv = Skv, a.scale = scale;
  a.q_tiles = (Sq + BQ - 1) / BQ;
  a.tiles = B * H * a.q_tiles;
  if (grid < 1 || Sq % SLICE || Skv % BKV) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_q, map_k, map_v, map_o;
  err = encode_bshd(&map_q, q, B, Sq, H, D, q_sb, q_ss, BQ);
  if (err == 0) err = encode_bshd(&map_k, k, B, Skv, H, D, k_sb, k_ss, BKV);
  if (err == 0) err = encode_bshd(&map_v, v, B, Skv, H, D, v_sb, v_ss, BKV);
  if (err == 0) err = encode_bshd(&map_o, out, B, Sq, H, D, (long long)Sq * H * D,
                                  (long long)H * D, SLICE);
  if (err != 0) return err;
  flash_d64_kernel<NWG><<<grid, threads(NWG), SMEM_BYTES, stream>>>(map_q, map_k, map_v, map_o, a);
  return static_cast<int>(cudaGetLastError());
}

// The cross-attention launch: q through (d, head, row, batch) boxes of BQ
// rows, k and v through boxes of BKV keys (past Skv zero-filled), then `grid`
// persistent blocks, each walking the tiles strided by the grid.
template <int NWG, int BKV>
int launch_cross(const void* q, const void* k, const void* v, void* out, int B, int H, int Sq,
                 int Skv, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                 long long v_sb, long long v_ss, float scale, int grid, cudaStream_t stream) {
  using namespace d64;
  constexpr int BQ = NWG * SLICE, SMEM_BYTES = cross::smem_bytes(NWG, BKV);
  static unsigned long long configured = 0;
  int err = configure(flash_d64_kernel_cross<NWG, BKV>, SMEM_BYTES, configured);
  if (err != 0) return err;
  if (grid < 1 || Sq % SLICE || Skv < 1 || Skv > BKV)
    return static_cast<int>(cudaErrorInvalidValue);
  WalkArgs a{};
  a.H = H, a.Skv = Skv, a.scale = scale;
  a.q_tiles = (Sq + BQ - 1) / BQ;
  a.tiles = B * H * a.q_tiles;
  CUtensorMap map_q, map_k, map_v, map_o;
  err = encode_bshd(&map_q, q, B, Sq, H, D, q_sb, q_ss, BQ);
  if (err == 0) err = encode_bshd(&map_k, k, B, Skv, H, D, k_sb, k_ss, BKV);
  if (err == 0) err = encode_bshd(&map_v, v, B, Skv, H, D, v_sb, v_ss, BKV);
  if (err == 0) err = encode_bshd(&map_o, out, B, Sq, H, D, (long long)Sq * H * D,
                                  (long long)H * D, SLICE);
  if (err != 0) return err;
  flash_d64_kernel_cross<NWG, BKV>
      <<<grid, threads(NWG), SMEM_BYTES, stream>>>(map_q, map_k, map_v, map_o, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// What the host-side plan (ops/flash_attention.py `plan`) mirrors, for head
// dim d and q tile bq: which = 1 the kv tile, 2 the K ring's stages (D = 64:
// KV tiles, and V's ring is as deep; D = 512: panels of 64 columns), 3 the
// dynamic shared memory in bytes, 4 the V ring's stages (D = 512: per PV
// warpgroup, slabs of `which = 5` keys); -1 where this library has no such
// instance.
extern "C" int flash_attention_geometry(int d, int bq, int which) {
  const bool is64 = d == 64 && (bq == 128 || bq == 192);
  if (!is64 && !(d == 512 && bq == d512::BQ)) return -1;
  switch (which) {
    case 1: return is64 ? d64::BKV : d512::BKV;
    case 2: return is64 ? d64::KV_STAGES : d512::K_STAGES;
    case 3: return is64 ? d64::smem_bytes(bq / d64::SLICE) : d512::SMEM_BYTES;
    case 4: return is64 ? d64::KV_STAGES : d512::V_STAGES;
    case 5: return is64 ? d64::BKV : d512::V_ROWS;
    default: return -1;
  }
}

// Sq and Skv must be multiples of 128 (the dispatcher's gate); D is 64 or
// 512.  Strides are in elements: q[b, s, h, d] = q + b*q_sb + s*q_ss + h*D + d.
// bq, bkv and grid come from the plan; bq picks the instance
// (D = 64: 128 or 192 rows, two or three consumer warpgroups; D = 512: 64
// rows) and bkv must be the tile this library was built with.  Returns the
// CUDA error code of the launch (0 on success), 10000 + a CUresult where a
// tensor map could not be encoded, or -1 for a D this library was not built
// for.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int B, int H, int Sq, int Skv, int D, long long q_sb,
                                    long long q_ss, long long k_sb, long long k_ss,
                                    long long v_sb, long long v_ss, float scale, int bq,
                                    int bkv, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 64 && D != 512) return -1;
  const int built = flash_attention_geometry(D, bq, 1);
  if (built < 0 || bkv != built) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 512)
    return launch_d512(q, k, v, out, B, H, Sq, Skv, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                       grid, s);
  if (bq == 128)
    return launch_d64<2>(q, k, v, out, B, H, Sq, Skv, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                         grid, s);
  return launch_d64<3>(q, k, v, out, B, H, Sq, Skv, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                       grid, s);
}

// The cross-attention kernel's geometry for q tile bq and KV tile bkv (what
// ops/flash_attention.py `plan_cross` mirrors): which = 1 the Q ring's stages,
// 2 the K / V ring's stages, 3 the dynamic shared memory in bytes; -1 where
// this library has no such instance.
extern "C" int cross_attention_geometry(int bq, int bkv, int which) {
  if ((bq != 128 && bq != 192) || (bkv != 80 && bkv != 128)) return -1;
  switch (which) {
    case 1: return cross::Q_STAGES;
    case 2: return cross::KV_STAGES;
    case 3: return cross::smem_bytes(bq / d64::SLICE, bkv);
    default: return -1;
  }
}

// Cross-attention, all keys in one KV tile: D = 64, 1 <= Skv <= bkv, Sq a
// multiple of 64 (the dispatcher's gate, ops/flash_attention.py
// `supports_cross`).  Arguments as flash_attention_bf16's; bq (128 or 192
// rows) and bkv (80 or 128 keys) pick the instance, grid comes from the plan.
extern "C" int cross_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int B, int H, int Sq, int Skv, int D, long long q_sb,
                                    long long q_ss, long long k_sb, long long k_ss,
                                    long long v_sb, long long v_ss, float scale, int bq,
                                    int bkv, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 64) return -1;
  if (cross_attention_geometry(bq, bkv, 1) < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (bq == 128 && bkv == 80)
    return launch_cross<2, 80>(q, k, v, out, B, H, Sq, Skv, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                               scale, grid, s);
  if (bq == 128)
    return launch_cross<2, 128>(q, k, v, out, B, H, Sq, Skv, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                                scale, grid, s);
  if (bkv == 80)
    return launch_cross<3, 80>(q, k, v, out, B, H, Sq, Skv, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                               scale, grid, s);
  return launch_cross<3, 128>(q, k, v, out, B, H, Sq, Skv, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                              scale, grid, s);
}
