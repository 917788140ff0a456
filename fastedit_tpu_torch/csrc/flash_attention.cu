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
// D = 512, `flash_kernel` (two calls per edit), mma.sync m16n8k16, one block
// per (batch*head, q tile): a warp's O slice for 16 rows would need 256
// registers a thread, so the warps split D instead.
// Per kv tile: (1) S = Q K^T, written to shared memory in fp32; (2) an
// online-softmax pass over S rows, writing P in bf16 and the per-row
// rescale factor; (3) O = alpha*O + P V, each warp owning a column slice
// of D for all q rows, V read transposed by ldmatrix.trans.  32-row q tiles
// need ~107 KB of shared memory, so the kernel uses dynamic shared memory
// and raises its limit with cudaFuncSetAttribute.

#include "hopper.cuh"

namespace {

using namespace hopper;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
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

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two 8x8 bf16 matrices, transposed: the B fragment of an m16n8k16 MMA
// whose B (k x n) is stored k-major, n contiguous.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const __nv_bfloat16* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

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

struct D64Args {
  int H, Skv;
  int q_tiles, tiles;  // q tiles per head; all tiles: B * H * q_tiles
  float scale;
};

template <int NWG>
__global__ void __launch_bounds__(d64::threads(NWG), 1)
flash_d64_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_o, const D64Args p) {
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

template <int D, int BQ, int BKV, int NWARPS>
struct Cfg {
  static constexpr int NTHREADS = NWARPS * 32;
  static constexpr int LDQ = D + 8;     // bf16 row stride of Q, K, V tiles
  static constexpr int LDS = BKV + 4;   // fp32 row stride of S
  static constexpr int LDP = BKV + 8;   // bf16 row stride of P
  static constexpr int MT = BQ / 16;    // m16 tiles over q rows
  static constexpr int ST = BKV / 8;    // n8 tiles over kv columns of S
  static constexpr int OT = D / 8;      // n8 tiles over D of O
  static constexpr int OT_W = OT / NWARPS;  // O column tiles per warp
  static constexpr int TPR = NTHREADS / BQ;  // softmax threads per q row
  static constexpr int CPT = BKV / TPR;      // S columns per softmax thread
  static constexpr size_t SMEM =
      sizeof(__nv_bfloat16) * (size_t)(BQ + 2 * BKV) * LDQ + sizeof(float) * (size_t)BQ * LDS +
      sizeof(__nv_bfloat16) * (size_t)BQ * LDP + sizeof(float) * 3 * BQ;
  static_assert(OT % NWARPS == 0, "D/8 must split evenly over the warps");
  static_assert(NTHREADS % BQ == 0 && TPR <= 32 && (TPR & (TPR - 1)) == 0, "softmax split");
  static_assert(BKV % TPR == 0, "softmax columns");
};

template <int D, int BQ, int BKV, int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32)
flash_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int H,
             int Sq, int Skv, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
             long long v_sb, long long v_ss, float scale) {
  using C = Cfg<D, BQ, BKV, NWARPS>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * C::LDQ;
  __nv_bfloat16* Vs = Ks + BKV * C::LDQ;
  float* Ss = reinterpret_cast<float*>(Vs + BKV * C::LDQ);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(Ss + BQ * C::LDS);
  float* m_s = reinterpret_cast<float*>(Ps + BQ * C::LDP);
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tg = lane & 3;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int q0 = blockIdx.x * BQ;
  const __nv_bfloat16* qg = q + b * q_sb + (long long)h * D;
  const __nv_bfloat16* kg = k + b * k_sb + (long long)h * D;
  const __nv_bfloat16* vg = v + b * v_sb + (long long)h * D;

  constexpr int VPR = D / 8;  // 16-byte vectors per row

  // Q tile, scaled in bf16 exactly as the TPU kernel does (q * bf16(scale)).
  const __nv_bfloat16 scale_bf = __float2bfloat16(scale);
  for (int i = tid; i < BQ * VPR; i += C::NTHREADS) {
    const int r = i / VPR, c = (i - r * VPR) * 8;
    uint4 raw = *reinterpret_cast<const uint4*>(qg + (long long)(q0 + r) * q_ss + c);
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __hmul(e[j], scale_bf);
    *reinterpret_cast<uint4*>(Qs + r * C::LDQ + c) = raw;
  }
  for (int r = tid; r < BQ; r += C::NTHREADS) {
    m_s[r] = -1e30f;
    l_s[r] = 0.f;
  }

  float o[C::MT][C::OT_W][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::OT_W; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[i][j][r] = 0.f;

  for (int kv0 = 0; kv0 < Skv; kv0 += BKV) {
    for (int i = tid; i < BKV * VPR; i += C::NTHREADS) {
      const int r = i / VPR, c = (i - r * VPR) * 8;
      cp_async16(Ks + r * C::LDQ + c, kg + (long long)(kv0 + r) * k_ss + c);
    }
    cp_async_commit();
    for (int i = tid; i < BKV * VPR; i += C::NTHREADS) {
      const int r = i / VPR, c = (i - r * VPR) * 8;
      cp_async16(Vs + r * C::LDQ + c, vg + (long long)(kv0 + r) * v_ss + c);
    }
    cp_async_commit();
    cp_async_wait<1>();  // K has landed; V may still be in flight
    __syncthreads();

    // (1) S = Q K^T, one m16n8 tile at a time, tiles dealt round-robin.
    for (int t = warp; t < C::MT * C::ST; t += NWARPS) {
      const int mi = t / C::ST, nj = t - (t / C::ST) * C::ST;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* qa = Qs + (mi * 16 + g) * C::LDQ + tg * 2;
      const __nv_bfloat16* kb = Ks + (nj * 8 + g) * C::LDQ + tg * 2;
#pragma unroll 8
      for (int ks = 0; ks < D; ks += 16) {
        uint32_t a[4], bb[2];
        a[0] = lds32(qa + ks);
        a[1] = lds32(qa + 8 * C::LDQ + ks);
        a[2] = lds32(qa + ks + 8);
        a[3] = lds32(qa + 8 * C::LDQ + ks + 8);
        bb[0] = lds32(kb + ks);
        bb[1] = lds32(kb + ks + 8);
        mma_bf16(s, a, bb);
      }
      float* sp = Ss + (mi * 16 + g) * C::LDS + nj * 8 + tg * 2;
      sp[0] = s[0];
      sp[1] = s[1];
      sp[8 * C::LDS] = s[2];
      sp[8 * C::LDS + 1] = s[3];
    }
    __syncthreads();

    // (2) online softmax: TPR consecutive threads share one q row.
    {
      const int r = tid / C::TPR;
      const int part = tid - r * C::TPR;
      const float* srow = Ss + r * C::LDS + part * C::CPT;
      float mx = -1e30f;
#pragma unroll
      for (int c = 0; c < C::CPT; ++c) mx = fmaxf(mx, srow[c]);
#pragma unroll
      for (int off = C::TPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      __nv_bfloat16* prow = Ps + r * C::LDP + part * C::CPT;
#pragma unroll
      for (int c = 0; c < C::CPT; ++c) {
        const float p = __expf(srow[c] - m_new);
        sum += p;
        prow[c] = __float2bfloat16(p);
      }
#pragma unroll
      for (int off = C::TPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (part == 0) {
        const float alpha = __expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // (3) O = alpha * O + P V on this warp's column slice of D.
#pragma unroll
    for (int mi = 0; mi < C::MT; ++mi) {
      const float a0 = a_s[mi * 16 + g], a1 = a_s[mi * 16 + g + 8];
#pragma unroll
      for (int j = 0; j < C::OT_W; ++j) {
        o[mi][j][0] *= a0;
        o[mi][j][1] *= a0;
        o[mi][j][2] *= a1;
        o[mi][j][3] *= a1;
      }
      const __nv_bfloat16* pa = Ps + (mi * 16 + g) * C::LDP + tg * 2;
#pragma unroll
      for (int ks = 0; ks < BKV; ks += 16) {
        uint32_t a[4];
        a[0] = lds32(pa + ks);
        a[1] = lds32(pa + 8 * C::LDP + ks);
        a[2] = lds32(pa + ks + 8);
        a[3] = lds32(pa + 8 * C::LDP + ks + 8);
#pragma unroll
        for (int j = 0; j < C::OT_W; ++j) {
          const int d0 = (warp * C::OT_W + j) * 8;
          uint32_t bb[2];
          ldmatrix_x2_trans(bb, Vs + (ks + (lane & 15)) * C::LDQ + d0);
          mma_bf16(o[mi][j], a, bb);
        }
      }
    }
    __syncthreads();  // K, V, S, P are rewritten by the next kv tile
  }

  // Finalise: O / l, one rounding to bf16, BSHD contiguous output.
#pragma unroll
  for (int mi = 0; mi < C::MT; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mi * 16 + g + half * 8;
      const float inv = 1.f / l_s[r];
      __nv_bfloat16* orow = out + (((long long)b * Sq + q0 + r) * H + h) * D;
#pragma unroll
      for (int j = 0; j < C::OT_W; ++j) {
        const int d = (warp * C::OT_W + j) * 8 + tg * 2;
        __nv_bfloat162 pr;
        pr.x = __float2bfloat16(o[mi][j][half * 2] * inv);
        pr.y = __float2bfloat16(o[mi][j][half * 2 + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = pr;
      }
    }
  }
}

template <int D, int BQ, int BKV, int NWARPS>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int Sq,
           int Skv, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
           long long v_sb, long long v_ss, float scale, cudaStream_t stream) {
  using C = Cfg<D, BQ, BKV, NWARPS>;
  auto kern = flash_kernel<D, BQ, BKV, NWARPS>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid(Sq / BQ, B * H);
  kern<<<grid, C::NTHREADS, C::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), H, Sq, Skv, q_sb,
      q_ss, k_sb, k_ss, v_sb, v_ss, scale);
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
  static unsigned long long configured = 0;  // one bit per device
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!(configured >> (device & 63) & 1)) {
    e = cudaFuncSetAttribute(flash_d64_kernel<NWG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured |= 1ull << (device & 63);
  }
  D64Args a{};
  a.H = H, a.Skv = Skv, a.scale = scale;
  a.q_tiles = (Sq + BQ - 1) / BQ;
  a.tiles = B * H * a.q_tiles;
  if (grid < 1 || Sq % SLICE || Skv % BKV) return static_cast<int>(cudaErrorInvalidValue);
  auto encode = [&](CUtensorMap* map, const void* base, int S, long long sb, long long ss,
                    int rows) {
    const cuuint64_t dims[4] = {D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[3] = {D * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
    const cuuint32_t box[4] = {D, 1, (cuuint32_t)rows, 1};
    return encode_map(map, base, 4, dims, strides, box);
  };
  CUtensorMap map_q, map_k, map_v, map_o;
  int err = encode(&map_q, q, Sq, q_sb, q_ss, BQ);
  if (err == 0) err = encode(&map_k, k, Skv, k_sb, k_ss, BKV);
  if (err == 0) err = encode(&map_v, v, Skv, v_sb, v_ss, BKV);
  if (err == 0) err = encode(&map_o, out, Sq, (long long)Sq * H * D, (long long)H * D, SLICE);
  if (err != 0) return err;
  flash_d64_kernel<NWG><<<grid, threads(NWG), SMEM_BYTES, stream>>>(map_q, map_k, map_v, map_o, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// What the host-side plan (ops/flash_attention.py `plan`) mirrors, for head
// dim d and q tile bq: which = 1 the kv tile, 2 the kv stages, 3 the dynamic
// shared memory in bytes; -1 where this library has no such instance.
extern "C" int flash_attention_geometry(int d, int bq, int which) {
  using C512 = Cfg<512, 32, 32, 8>;
  const bool d64 = d == 64 && (bq == 128 || bq == 192);
  if (!d64 && !(d == 512 && bq == 32)) return -1;
  switch (which) {
    case 1: return d64 ? d64::BKV : 32;
    case 2: return d64 ? d64::KV_STAGES : 1;
    case 3: return d64 ? d64::smem_bytes(bq / d64::SLICE) : (int)C512::SMEM;
    default: return -1;
  }
}

// Sq and Skv must be multiples of 128 (the dispatcher's gate); D is 64 or
// 512.  Strides are in elements: q[b, s, h, d] = q + b*q_sb + s*q_ss + h*D + d.
// bq, bkv and grid come from the plan; bq picks the instance
// (D = 64: 128 or 192 rows, two or three consumer warpgroups) and bkv must be
// the tile this library was built with.  Returns the CUDA error code of the
// launch (0 on success), 10000 + a CUresult where a tensor map could not be
// encoded, or -1 for a D this library was not built for.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int B, int H, int Sq, int Skv, int D, long long q_sb,
                                    long long q_ss, long long k_sb, long long k_ss,
                                    long long v_sb, long long v_ss, float scale, int bq,
                                    int bkv, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 64 && D != 512) return -1;
  if (bkv != flash_attention_geometry(D, bq, 1)) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64 && bq == 128)
    return launch_d64<2>(q, k, v, out, B, H, Sq, Skv, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                         grid, s);
  if (D == 64)
    return launch_d64<3>(q, k, v, out, B, H, Sq, Skv, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                         grid, s);
  return launch<512, 32, 32, 8>(q, k, v, out, B, H, Sq, Skv, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                                scale, s);
}
