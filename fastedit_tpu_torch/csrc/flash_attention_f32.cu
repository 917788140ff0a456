// Flash attention, BSHD fp32, at D = 64: softmax(Q K^T * scale) V with fp32
// operands, fp32 multiplies (FFMA, not TF32), an fp32 online softmax and fp32
// accumulation of O.  The fp32 instance of fastedit_tpu/ops/flash_attention.py
// `_flash_packed` (the UNet's 64-dim heads), which flash_attention.cu ports in
// bf16; the other TPU kernel, `_flash_bhsd` (the VAE mid block's one 512-dim
// head), runs in fp32 on the tensor cores in 3xTF32 (flash_attention_tf32x3.cu).
//
//   flash_f32_d64_kernel   a block of 256 threads takes a q tile of 64 rows
//                          of one (batch, head); per KV tile of 64 keys it
//                          stages K and V in shared memory (K transposed),
//                          computes S (each thread 4 rows x 4 keys), the
//                          online softmax of its rows (the 16 threads of a row
//                          group reduce by shuffles), P through shared memory,
//                          and O += P V (each thread 4 rows x 4 columns).
//
// Exponentials are exp2 of (s * scale * log2 e - running max), the same
// function as exp(s * scale - max).  Every sum runs in a fixed order: two
// launches give the same bits.  The schedule (tiles, grid, shared memory)
// comes from ops/flash_attention.plan_f32, which attention_tiled_plain_f32
// walks in PyTorch for the tests.
//
// What bounds it on an H100 SXM: operations.  4 * B * H * Sq * Skv * D
// FLOPs at 67 TFLOP/s (fp32 outside the tensor cores, NVIDIA's data sheet)
// against 4 * B * H * (2 Sq + 2 Skv) * D bytes at 3.35 TB/s: 2 * Sq * Skv /
// (Sq + Skv) FLOPs per byte, 512 to 2048 here, far above the fp32 ridge point.
// The design keeps a KV tile in shared memory for a whole q tile and feeds
// the FFMAs from registers (16 FFMAs per two shared-memory loads in the
// products); the tensor cores (3xTF32, as the D = 512 kernel does) are the
// way to the bound, queued in ROADMAP.md.

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

}  // namespace

// Shared memory of the kernel for head dim d (64), or -1.
extern "C" int flash_attention_f32_smem_bytes(int d) { return d == D64 ? D64_SMEM : -1; }

// q [B, Sq, H, D], k and v [B, Skv, H, D] fp32 with contiguous heads and the
// given batch and row strides (elements; multiples of 4, 16-byte aligned
// bases) -> out [B, Sq, H, D] fp32, contiguous.  D is 64 (Sq, Skv multiples
// of 64); one block per q tile of one (batch, head).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out, int B,
                                   int H, int Sq, int Skv, int D, long long sq_b, long long sq_s,
                                   long long sk_b, long long sk_s, long long sv_b, long long sv_s,
                                   float scale, void* stream) {
  const int bq = BQ64, bkv = BKV64;
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16 ==
                        0) &&
                       ((sq_b | sq_s | sk_b | sk_s | sv_b | sv_s) % 4 == 0);
  if (D != D64 || B < 1 || H < 1 || Sq < bq || Skv < bkv || Sq % bq ||
      Skv % bkv || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (long long)B * H * (Sq / bq);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
         static_cast<float*>(out), B, H, Sq, Skv, sq_b, sq_s, sk_b, sk_s, sv_b, sv_s,
         scale * LOG2E};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static unsigned long long configured = 0;
  if (int err = allow_smem(flash_f32_d64_kernel, D64_SMEM, configured)) return err;
  flash_f32_d64_kernel<<<(int)blocks, THREADS, D64_SMEM, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
