// Flash attention, BSHD fp32: softmax(Q K^T * scale) V with fp32 operands,
// fp32 multiplies (FFMA, not TF32), an fp32 online softmax and fp32
// accumulation of O.  The fp32 instances of the two TPU kernels that
// flash_attention.cu ports in bf16: fastedit_tpu/ops/flash_attention.py
// `_flash_packed` (the UNet's 64-dim heads) and `_flash_bhsd` (the VAE mid
// block's one 512-dim head).  Two SIMT kernels, one C entry:
//
//   flash_f32_d64_kernel   a block of 256 threads takes a q tile of 64 rows
//                          of one (batch, head); per KV tile of 64 keys it
//                          stages K and V in shared memory (K transposed),
//                          computes S (each thread 4 rows x 4 keys), the
//                          online softmax of its rows (the 16 threads of a row
//                          group reduce by shuffles), P through shared memory,
//                          and O += P V (each thread 4 rows x 4 columns).
//   flash_f32_d512_kernel  a 64 x 512 fp32 K tile alone would be 128 KB, so a
//                          block takes 32 q rows and KV tiles of 32 keys, with
//                          Q, K and V each a 64 KB tile in shared memory, K
//                          and V loaded with cp.async in turns so that V(j)
//                          lands during S(j) and K(j + 1) during PV(j).  S
//                          splits the 512 columns over the eight warps (a lane
//                          per key, each K value serving all 32 rows); the
//                          eight partial S are summed through shared memory;
//                          O's 512 columns are split over the threads (each 16
//                          rows x 4 columns, 64 accumulators).
//
// Exponentials are exp2 of (s * scale * log2 e - running max), the same
// function as exp(s * scale - max).  Every sum runs in a fixed order: two
// launches give the same bits.  The schedule (tiles, grid, shared memory)
// comes from ops/flash_attention.plan_f32, which attention_tiled_plain_f32
// walks in PyTorch for the tests.
//
// What bounds them on an H100 SXM: operations.  4 * B * H * Sq * Skv * D
// FLOPs at 67 TFLOP/s (fp32 outside the tensor cores, NVIDIA's data sheet)
// against 4 * B * H * (2 Sq + 2 Skv) * D bytes at 3.35 TB/s: 2 * Sq * Skv /
// (Sq + Skv) FLOPs per byte, 512 to 2048 here, far above the fp32 ridge point.
// The design keeps a KV tile in shared memory for a whole q tile and feeds
// the FFMAs from registers (16 or 64 FFMAs per two shared-memory loads in the
// products); the tensor cores (3xTF32) are the way to the bound, queued in
// ROADMAP.md.

#include "simt_f32.cuh"

namespace {

using namespace simt;

constexpr int THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* out;  // [B, Sq, H, D], contiguous
  int B, H, Sq, Skv;
  long long sq_b, sq_s, sk_b, sk_s, sv_b, sv_s;  // batch and row strides, in elements
  float scale_log2e;
};

// ---------------------------------------------------------------- D = 64

constexpr int D64 = 64, BQ64 = 64, BKV64 = 64;
constexpr int D64_SMEM = 4 * 64 * 64 * 4;  // Qt, Kt, V, Pt

__global__ void __launch_bounds__(THREADS) flash_f32_d64_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;               // [d][row]
  float* kt = qt + D64 * BQ64;    // [d][key]
  float* vs = kt + D64 * BKV64;   // [key][d]
  float* pt = vs + BKV64 * D64;   // [key][row]

  const int q_tiles = a.Sq / BQ64;
  const int qi = blockIdx.x % q_tiles, bh = blockIdx.x / q_tiles;
  const int h = bh % a.H, b = bh / a.H, q0 = qi * BQ64;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  // Q transposed: thread i takes row i % 64, columns 4 (i / 64) .. + 4
  const float* qb = a.q + b * a.sq_b + (long long)q0 * a.sq_s + h * D64;
  for (int i = tid; i < BQ64 * D64 / 4; i += THREADS) {
    const int row = i & 63, dq = i >> 6;
    const float4 v = *reinterpret_cast<const float4*>(qb + row * a.sq_s + dq * 4);
    qt[(dq * 4 + 0) * BQ64 + row] = v.x;
    qt[(dq * 4 + 1) * BQ64 + row] = v.y;
    qt[(dq * 4 + 2) * BQ64 + row] = v.z;
    qt[(dq * 4 + 3) * BQ64 + row] = v.w;
  }

  float o[4][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) o[i][c] = 0.f;
  }

  const int kv_tiles = a.Skv / BKV64;
  for (int j = 0; j < kv_tiles; ++j) {
    __syncthreads();  // the previous tile's K, V and P are read
    const float* kb = a.k + b * a.sk_b + (long long)j * BKV64 * a.sk_s + h * D64;
    const float* vb = a.v + b * a.sv_b + (long long)j * BKV64 * a.sv_s + h * D64;
    for (int i = tid; i < BKV64 * D64 / 4; i += THREADS) {
      const int key = i & 63, dq = i >> 6;
      const float4 v = *reinterpret_cast<const float4*>(kb + key * a.sk_s + dq * 4);
      kt[(dq * 4 + 0) * BKV64 + key] = v.x;
      kt[(dq * 4 + 1) * BKV64 + key] = v.y;
      kt[(dq * 4 + 2) * BKV64 + key] = v.z;
      kt[(dq * 4 + 3) * BKV64 + key] = v.w;
      const int vk = i >> 4, vd = (i & 15) * 4;
      *reinterpret_cast<float4*>(vs + vk * D64 + vd) =
          *reinterpret_cast<const float4*>(vb + vk * a.sv_s + vd);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D64; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qt + d * BQ64 + ty * 4);
      const float4 kv = *reinterpret_cast<const float4*>(kt + d * BKV64 + tx * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w}, ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qa[i], ka[c], s[i][c]);
    }
    // online softmax of rows ty*4..+4 across the 16 threads (lanes) of the row group
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -1e30f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] *= a.scale_log2e;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx), alpha = exp2f(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = exp2f(s[i][c] - mn);
        sum += s[i][c];
      }
#pragma unroll
      for (int off = 8; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < 4; ++c) o[i][c] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(pt + (tx * 4 + c) * BQ64 + ty * 4) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();
#pragma unroll 8
    for (int key = 0; key < BKV64; ++key) {
      const float4 pv = *reinterpret_cast<const float4*>(pt + key * BQ64 + ty * 4);
      const float4 vv = *reinterpret_cast<const float4*>(vs + key * D64 + tx * 4);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w}, va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[i][c] = fmaf(pa[i], va[c], o[i][c]);
    }
  }
  float* ob = a.out + (((long long)b * a.Sq + q0) * a.H + h) * D64;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.f / l[i];
    *reinterpret_cast<float4*>(ob + (long long)(ty * 4 + i) * a.H * D64 + tx * 4) =
        make_float4(o[i][0] * inv, o[i][1] * inv, o[i][2] * inv, o[i][3] * inv);
  }
}

// --------------------------------------------------------------- D = 512

constexpr int D512 = 512, BQ512 = 32, BKV512 = 32;
constexpr int KROW = D512 + 4;  // K's rows padded: lane j's 16-byte loads hit banks 4j..4j+3
constexpr int WARPS = THREADS / 32;
constexpr int D512_SMEM = (BQ512 * D512 + BKV512 * KROW + BKV512 * D512 +
                           WARPS * BQ512 * BKV512 + 2 * BQ512) * 4;

__global__ void __launch_bounds__(THREADS, 1) flash_f32_d512_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // [row][d]
  float* ks = qs + BQ512 * D512;             // [key][KROW]
  float* vs = ks + BKV512 * KROW;            // [key][d]
  float* part = vs + BKV512 * D512;          // [warp][row][key]; P [key][row] after the sum
  float* alpha_s = part + WARPS * BQ512 * BKV512;  // [row]
  float* l_s = alpha_s + BQ512;                    // [row]

  const int q_tiles = a.Sq / BQ512;
  const int qi = blockIdx.x % q_tiles, bh = blockIdx.x / q_tiles;
  const int h = bh % a.H, b = bh / a.H, q0 = qi * BQ512;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const float* qb = a.q + b * a.sq_b + (long long)q0 * a.sq_s + h * D512;
  const float* kb = a.k + b * a.sk_b + h * D512;
  const float* vb = a.v + b * a.sv_b + h * D512;
  auto load_rows = [&](float* dst, int row_len, const float* src, long long stride) {
    for (int i = tid; i < 32 * D512 / 4; i += THREADS) {
      const int row = i >> 7, c = (i & 127) * 4;
      cp_async16(dst + row * row_len + c, src + row * stride + c, true);
    }
    cp_async_commit();
  };
  load_rows(qs, D512, qb, a.sq_s);
  load_rows(ks, KROW, kb, a.sk_s);  // K(0)

  // softmax ownership: row sr = tid / 8, keys 4 (tid % 8) .. + 4
  const int sr = tid >> 3, sk = (tid & 7) * 4;
  float m_row = -1e30f, l_row = 0.f;
  // PV ownership: rows 16 (tid / 128) .. + 16, columns 4 (tid % 128) .. + 4
  const int orow = (tid >> 7) * 16, ocol = (tid & 127) * 4;
  float o[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[i][c] = 0.f;

  const int kv_tiles = a.Skv / BKV512;
  for (int j = 0; j < kv_tiles; ++j) {
    load_rows(vs, D512, vb + (long long)j * BKV512 * a.sv_s, a.sv_s);  // V(j), during S(j)
    cp_async_wait<1>();  // Q and K(j) have landed
    __syncthreads();
    {  // S partial of warp's 64 columns: lane = key
      float s[BQ512];
#pragma unroll
      for (int r = 0; r < BQ512; ++r) s[r] = 0.f;
      const float* krow = ks + lane * KROW + warp * 64;
      const float* qcol = qs + warp * 64;
#pragma unroll 2
      for (int d = 0; d < 64; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
        for (int r = 0; r < BQ512; ++r) {
          const float4 qv = *reinterpret_cast<const float4*>(qcol + r * D512 + d);
          s[r] = fmaf(qv.x, kv.x, s[r]);
          s[r] = fmaf(qv.y, kv.y, s[r]);
          s[r] = fmaf(qv.z, kv.z, s[r]);
          s[r] = fmaf(qv.w, kv.w, s[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < BQ512; ++r) part[(warp * BQ512 + r) * BKV512 + lane] = s[r];
    }
    __syncthreads();  // K(j) and the partials are complete
    if (j + 1 < kv_tiles) load_rows(ks, KROW, kb + (long long)(j + 1) * BKV512 * a.sk_s, a.sk_s);
    float s4[4];
    {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {  // the warps' partials in a fixed order
        const float4 p = *reinterpret_cast<const float4*>(part + (w * BQ512 + sr) * BKV512 + sk);
        acc.x += p.x, acc.y += p.y, acc.z += p.z, acc.w += p.w;
      }
      s4[0] = acc.x * a.scale_log2e, s4[1] = acc.y * a.scale_log2e;
      s4[2] = acc.z * a.scale_log2e, s4[3] = acc.w * a.scale_log2e;
    }
    float mx = fmaxf(fmaxf(s4[0], s4[1]), fmaxf(s4[2], s4[3]));
#pragma unroll
    for (int off = 4; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float mn = fmaxf(m_row, mx), alpha = exp2f(m_row - mn);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s4[c] = exp2f(s4[c] - mn);
      sum += s4[c];
    }
#pragma unroll
    for (int off = 4; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l_row = l_row * alpha + sum;
    m_row = mn;
    __syncthreads();  // every partial is read: P takes their place
#pragma unroll
    for (int c = 0; c < 4; ++c) part[(sk + c) * BQ512 + sr] = s4[c];
    if ((tid & 7) == 0) alpha_s[sr] = alpha;
    if (j + 1 < kv_tiles) cp_async_wait<1>();  // V(j) has landed (K(j + 1) may not)
    else cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float al = alpha_s[orow + i];
#pragma unroll
      for (int c = 0; c < 4; ++c) o[i][c] *= al;
    }
#pragma unroll 4
    for (int key = 0; key < BKV512; ++key) {
      const float4 vv = *reinterpret_cast<const float4*>(vs + key * D512 + ocol);
#pragma unroll
      for (int i4 = 0; i4 < 16; i4 += 4) {
        const float4 pv = *reinterpret_cast<const float4*>(part + key * BQ512 + orow + i4);
        const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i4 + i][0] = fmaf(pa[i], vv.x, o[i4 + i][0]);
          o[i4 + i][1] = fmaf(pa[i], vv.y, o[i4 + i][1]);
          o[i4 + i][2] = fmaf(pa[i], vv.z, o[i4 + i][2]);
          o[i4 + i][3] = fmaf(pa[i], vv.w, o[i4 + i][3]);
        }
      }
    }
    __syncthreads();  // V(j), P and alpha are read
  }
  if ((tid & 7) == 0) l_s[sr] = l_row;
  __syncthreads();
  float* ob = a.out + (((long long)b * a.Sq + q0) * a.H + h) * D512;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float inv = 1.f / l_s[orow + i];
    *reinterpret_cast<float4*>(ob + (long long)(orow + i) * a.H * D512 + ocol) =
        make_float4(o[i][0] * inv, o[i][1] * inv, o[i][2] * inv, o[i][3] * inv);
  }
}

}  // namespace

// Shared memory of the kernel for head dim d (64 or 512), or -1.
extern "C" int flash_attention_f32_smem_bytes(int d) {
  return d == D64 ? D64_SMEM : d == D512 ? D512_SMEM : -1;
}

// q [B, Sq, H, D], k and v [B, Skv, H, D] fp32 with contiguous heads and the
// given batch and row strides (elements; multiples of 4, 16-byte aligned
// bases) -> out [B, Sq, H, D] fp32, contiguous.  D is 64 (Sq, Skv multiples
// of 64) or 512 (multiples of 32); one block per q tile of one (batch, head).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out, int B,
                                   int H, int Sq, int Skv, int D, long long sq_b, long long sq_s,
                                   long long sk_b, long long sk_s, long long sv_b, long long sv_s,
                                   float scale, void* stream) {
  const int bq = D == D64 ? BQ64 : BQ512, bkv = D == D64 ? BKV64 : BKV512;
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16 ==
                        0) &&
                       ((sq_b | sq_s | sk_b | sk_s | sv_b | sv_s) % 4 == 0);
  if ((D != D64 && D != D512) || B < 1 || H < 1 || Sq < bq || Skv < bkv || Sq % bq ||
      Skv % bkv || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (long long)B * H * (Sq / bq);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
         static_cast<float*>(out), B, H, Sq, Skv, sq_b, sq_s, sk_b, sk_s, sv_b, sv_s,
         scale * LOG2E};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == D64) {
    static unsigned long long configured = 0;
    if (int err = allow_smem(flash_f32_d64_kernel, D64_SMEM, configured)) return err;
    flash_f32_d64_kernel<<<(int)blocks, THREADS, D64_SMEM, s>>>(a);
  } else {
    static unsigned long long configured = 0;
    if (int err = allow_smem(flash_f32_d512_kernel, D512_SMEM, configured)) return err;
    flash_f32_d512_kernel<<<(int)blocks, THREADS, D512_SMEM, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
