// Exact softmax attention with an online softmax (flash attention), bf16
// in and out, fp32 statistics and accumulator, BSHD layout read through
// strides (no transpose copy).
//
// Replaces both TPU kernels of fastedit_tpu/ops/flash_attention.py:
//   * `_flash_packed` / `_packed_kernel`, which packs two 64-dim heads into
//     the TPU's 128 lanes (UNet self-attention).  Head packing exists only
//     for the TPU's 128-wide matrix unit; here it is one head per block row.
//   * `_flash_bhsd` / `_flash_kernel` (one head per grid row, any D), used
//     for the VAE mid block's single 512-dim head.
// Semantics kept from the TPU kernels: the scale is folded into q in q's
// dtype (bf16 product), running max / sum / output accumulate in fp32,
// P is rounded to bf16 before P.V, the sum uses the unrounded P.
//
// What bounds it on an H100: operations.  4*Sq*Skv*D FLOPs against
// 2*(Sq+Skv)*D*2 bytes per head: thousands of FLOPs per byte at S >= 1024,
// far above the bf16 ridge point (~295 FLOP/byte).  The scores never touch
// HBM (the plain version writes an Sq x Skv fp32 matrix per head).
//
// Both variants: one block per (batch*head, q tile); the TPU's sequential
// kv grid axis becomes a loop inside the block; mma.sync m16n8k16.
//
// D = 64, `flash_d64_kernel` (the UNet's 34 self-attention calls per
// forward): each of 4 warps owns 16 q rows.  S = Q K^T stays in registers
// as m16n8 accumulators, the online softmax runs on them with quad
// shuffles, and P is re-packed in registers as the A operand of P.V (the
// accumulator layout of S is the A-fragment layout).  K and V tiles are
// double-buffered with cp.async and read with ldmatrix.
//
// D = 512, `flash_kernel` (two calls per edit): a warp's O slice for 16
// rows would need 256 registers a thread, so the warps split D instead.
// Per kv tile: (1) S = Q K^T, written to shared memory in fp32; (2) an
// online-softmax pass over S rows, writing P in bf16 and the per-row
// rescale factor; (3) O = alpha*O + P V, each warp owning a column slice
// of D for all q rows, V read transposed by ldmatrix.trans.  32-row q tiles
// need ~107 KB of shared memory, so the kernel uses dynamic shared memory
// and raises its limit with cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// Four 8x8 bf16 matrices; lane l supplies the address of row (l & 7) of
// matrix (l >> 3) and receives its share of each in r[0..3].
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const __nv_bfloat16* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const __nv_bfloat16* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Two fp32 values as one bf16x2 register, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

namespace d64 {
constexpr int D = 64, BQ = 64, BKV = 64, NTHREADS = 128;  // 4 warps x 16 q rows
constexpr int LD = D + 8;  // 144-byte rows: ldmatrix and the copies are conflict-free
constexpr int NT = BKV / 8;  // n8 tiles of S per kv tile
constexpr int OT = D / 8;    // n8 tiles of O
}  // namespace d64

__global__ void __launch_bounds__(d64::NTHREADS)
flash_d64_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int H,
                 int Sq, int Skv, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                 long long v_sb, long long v_ss, float scale) {
  using namespace d64;
  __shared__ __align__(128) __nv_bfloat16 Qs[BQ * LD];
  __shared__ __align__(128) __nv_bfloat16 Ks[2][BKV * LD];
  __shared__ __align__(128) __nv_bfloat16 Vs[2][BKV * LD];

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

  auto load_kv = [&](int tile, int stage) {
    const int kv0 = tile * BKV;
    for (int i = tid; i < BKV * (D / 8); i += NTHREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      cp_async16(&Ks[stage][r * LD + c], kg + (long long)(kv0 + r) * k_ss + c);
      cp_async16(&Vs[stage][r * LD + c], vg + (long long)(kv0 + r) * v_ss + c);
    }
    cp_async_commit();
  };

  // Q tile, scaled in bf16 exactly as the TPU kernel does (q * bf16(scale)).
  const __nv_bfloat16 scale_bf = __float2bfloat16(scale);
  for (int i = tid; i < BQ * (D / 8); i += NTHREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 raw = *reinterpret_cast<const uint4*>(qg + (long long)(q0 + r) * q_ss + c);
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __hmul(e[j], scale_bf);
    *reinterpret_cast<uint4*>(&Qs[r * LD + c]) = raw;
  }
  load_kv(0, 0);
  __syncthreads();

  // This warp's 16 q rows as A fragments, one per 16-wide k step of D.
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldmatrix_x4(qf[ks], &Qs[(warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8]);

  // Rows g and g + 8 of the warp's 16: running max, this thread's partial
  // sum (its quad's four partials are added at the end), and O.
  float m_run[2] = {-1e30f, -1e30f};
  float l_part[2] = {0.f, 0.f};
  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[j][r] = 0.f;

  // ldmatrix lane offsets: non-transposed B (rows = kv, k = d) and
  // transposed B (rows = kv, cols = d).
  const int kb_row = (lane >> 4) * 8 + (lane & 7), kb_col = ((lane >> 3) & 1) * 8;
  const int vb_row = ((lane >> 3) & 1) * 8 + (lane & 7), vb_col = (lane >> 4) * 8;

  const int ntiles = Skv / BKV;
  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    if (t + 1 < ntiles) {
      load_kv(t + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 kv columns, in registers.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t kb[4];
        ldmatrix_x4(kb, &Ks[st][(jp * 16 + kb_row) * LD + ks * 16 + kb_col]);
        mma_bf16(s[2 * jp], qf[ks], kb);
        mma_bf16(s[2 * jp + 1], qf[ks], kb + 2);
      }
    }

    // Online softmax on the registers; a row's four values per n8 tile are
    // spread over the 4 threads of a quad.
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = __expf(m_run[r] - mx[r]);
      m_run[r] = mx[r];
      l_part[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[j][e] - mx[e >> 1]);
        l_part[e >> 1] += p;
        s[j][e] = p;
      }
    }
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V: P (rounded to bf16) is the A operand, straight from S.
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < OT / 2; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, &Vs[st][(kk * 16 + vb_row) * LD + dp * 16 + vb_col]);
        mma_bf16(o[2 * dp], pa, vb);
        mma_bf16(o[2 * dp + 1], pa, vb + 2);
      }
    }
    __syncthreads();  // stage st is refilled by the next iteration's load
  }

  // Finalise: the quad's partial sums, O / l, one rounding to bf16.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_part[r] += __shfl_xor_sync(0xffffffffu, l_part[r], 1);
    l_part[r] += __shfl_xor_sync(0xffffffffu, l_part[r], 2);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + g + half * 8;
    const float inv = 1.f / l_part[half];
    __nv_bfloat16* orow = out + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      __nv_bfloat162 pr;
      pr.x = __float2bfloat16(o[j][half * 2] * inv);
      pr.y = __float2bfloat16(o[j][half * 2 + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + tg * 2) = pr;
    }
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

}  // namespace

// Sq and Skv must be multiples of 128 (the dispatcher's gate); D is 64 or
// 512.  Strides are in elements: q[b, s, h, d] = q + b*q_sb + s*q_ss + h*D + d.
// Returns the CUDA error code of the launch (0 on success), or -1 for a D
// this library was not built for.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int B, int H, int Sq, int Skv, int D, long long q_sb,
                                    long long q_ss, long long k_sb, long long k_ss,
                                    long long v_sb, long long v_ss, float scale,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    dim3 grid(Sq / d64::BQ, B * H);
    flash_d64_kernel<<<grid, d64::NTHREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), H, Sq, Skv, q_sb,
        q_ss, k_sb, k_ss, v_sb, v_ss, scale);
    return static_cast<int>(cudaGetLastError());
  }
  if (D == 512)
    return launch<512, 32, 32, 8>(q, k, v, out, B, H, Sq, Skv, q_sb, q_ss, k_sb, k_ss, v_sb,
                                  v_ss, scale, s);
  return -1;
}
