// Flash attention, BSHD fp32, on the tensor cores in 3xTF32: softmax(Q K^T *
// scale) V with an fp32 online softmax and fp32 O; every product of Q K^T and
// of P V is taken as three TF32 products (tf32x3.cuh).  Two kernels, each
// after a prologue launch (split_qkv_tf32_kernel) that writes Q and K as hi
// and lo copies [B*H, S, D] and V as hi and lo copies of V^T [B*H, D, S],
// once per call: both operands of wgmma are K-major at .tf32 (no transpose
// bit), so V, whose keys are the contraction of P V, is read transposed.
//
// flash_d64_tf32x3_kernel: the fp32 instance of
// fastedit_tpu/ops/flash_attention.py `_flash_packed` (the UNet's and the
// ControlNet's 64-dim heads; flash_d64_kernel in flash_attention.cu is the
// bf16 one).
//   * A tile is 128 q rows of one (batch, head), 64 for each of two consumer
//     warpgroups; its Q in hi and lo (2 x 32 KB) stays in shared memory for
//     the whole walk over the keys, landed by TMA once per tile.  A producer
//     warp streams K(j) (hi and lo panels of 64 keys x 32 columns) and V(j)^T
//     (hi and lo boxes of 64 columns x 32 keys) in turn through a ring of
//     five 32 KB stages; the blocks are persistent, q tile fastest.
//   * S = Q K^T, A and B through descriptors: each panel of 32 columns (four
//     k steps of three wgmmas m64n64k8, the two small products first) into a
//     fresh accumulator, added with an fp32 add ("Where the products are
//     summed" below).  The online softmax in the registers that hold S.
//   * P is split in registers and is A of P V straight from S's
//     accumulators.  A thread holds S's columns 2 quad and 2 quad + 1 of
//     each 8-key k step, where an A fragment at .tf32 wants columns quad and
//     quad + 4: the prologue writes V^T's keys in that order (key 8g + r at
//     8g + r / 2 + 4 (r % 2)), so the contraction runs over the keys in
//     another order and no value moves between threads.  Per box of 32 keys
//     the products go into a fresh accumulator, added into O with an fp32
//     add.  Registers: O, S (or the fresh accumulator) and P's fragments in
//     hi and lo (4 x 32), within the 168 a thread of a 288-thread block has.
//
// What bounds it on an H100 SXM: operations, 3 x 4 * B * H * Sq * Skv * 64
// TF32 FLOPs at 494.7 TFLOP/s (17.6 ms per edit) against the bytes of q, k, v
// and the output at 3.35 TB/s.  Inside the card: S's operands both come from
// shared memory (4 KB a wgmma m64n64k8, as many cycles at 128 bytes a cycle
// as the tensor cores take), and every 128-row tile streams K and V in hi and
// lo from L2 (64 KB per KV tile, 5 TB/s over 132 SMs at the tensor cores'
// rate).
//
// flash_d512_tf32x3_kernel: the fp32 instance of
// fastedit_tpu/ops/flash_attention.py `_flash_bhsd` (the VAE mid block's
// single head over a 128 x 128 latent: Sq = Skv = 16384, two calls per edit).
// flash_d512_kernel in flash_attention.cu is the bf16 instance of the same
// design; what changes at fp32:
//
//   * The prologue's copies take 3 x 64 MB at S = 16384, the first part of
//     the wrapper's scratch.
//   * A 64 x 512 Q tile in hi and lo is 256 KB, more than a block's 227 KB,
//     so Q is not kept: its panels of 32 columns are streamed with K's, a
//     stage holding the hi and lo panels of both (4 x 8 KB), three stages.
//     Each panel is four k steps of three wgmmas m64n64k8, A and B through
//     descriptors (128-byte swizzle rows of 32 values; a k step adds 32
//     bytes), into one fresh accumulator (see "Where the products are
//     summed" below).
//   * Twelve warps, as in bf16: a softmax warpgroup computes S for a KV tile
//     of 64 keys, the online softmax in its registers, and hands P (fp32)
//     and the rows' rescale factors through shared memory to two PV
//     warpgroups, two buffers deep, "full" and "empty" mbarriers either way;
//     the row sums go the same way at the end of a tile, as 1 / l.
//   * O's 512 columns take two passes over the keys of a q tile: in each a
//     PV warpgroup owns 128 columns (2 x 32 accumulators; 256 would need
//     them, a fresh accumulator and a stage's fragments in more than the 168
//     registers a thread has).  Pass 0 takes P and the rescale factors from
//     the softmax warpgroup and PV warpgroup 0 writes them to the second part
//     of the scratch, a region of each block's own (Skv / 64 x 16.25 KB: 536
//     MiB over 132 blocks at S = 16384); pass 1 reads them back in both PV
//     warpgroups.  That round trip is ~1.09 GB written and up to 2.2 GB read
//     per call at S = 16384 (the two warpgroups read the same lines close
//     together, so L2 may serve the second), 0.65-1 ms at 3.35 TB/s.
//   * A PV warpgroup reads its A fragments of P from shared memory (P is
//     stored with its 4-word groups XORed by the row, so the fragment loads
//     are conflict-free), splits them in registers and multiplies with A from
//     registers: m64n64k8 against a stage of V^T's hi and lo (32 keys x 64
//     columns, 2 x 8 KB; three stages a warpgroup), two k steps a wgmma
//     group, each group waited for before its fragments' registers are
//     loaded again.
//   * Every warpgroup loads what it consumes (one thread issues the TMA loads
//     under a predicate, a ring's depth ahead), as in bf16; blocks are
//     persistent, q tile fastest.  O / l is written from the registers.
//
// What bounds it on an H100 SXM: operations, 3 x 4 * B * H * Sq * Skv * 512
// TF32 FLOPs at 494.7 TFLOP/s (6.7 ms per edit) against the bytes of q, k, v
// and the output at 3.35 TB/s.  Inside the card the operands' traffic is the
// nearer limit: every 64-row q tile streams Q, K and V in hi and lo through
// shared memory (768 KB per KV tile), twice the bytes per FLOP of the bf16
// kernel, which keeps Q; and P's fragments make the round trip through the
// scratch above.

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int D = 512, BQ = 64, BKV = 64;
constexpr int PANEL = 32;                         // columns of a panel: 128 bytes
constexpr int PANELS = D / PANEL;
constexpr int TILE_BYTES = 64 * 128;              // 64 rows x one panel
constexpr int K_OFFSET = 2 * TILE_BYTES;          // a stage: Q hi, Q lo, K hi, K lo
constexpr int QK_STAGE = K_OFFSET + 2 * TILE_BYTES;
constexpr int QK_STAGES = 3;
constexpr int PV_GROUPS = 2;                      // warpgroups that multiply by V
constexpr int PASSES = 2;                         // O's column halves, one after the other
constexpr int COLS = D / PASSES / PV_GROUPS;      // a PV warpgroup's columns of O in a pass
constexpr int DC = COLS / 64;                     // their 64-column chunks
constexpr int VK = 32;                            // keys of a V stage: 128 bytes of V^T
constexpr int V_STAGE = 2 * TILE_BYTES;           // V^T hi and lo: 64 columns x 32 keys
constexpr int V_STAGES = 3;
constexpr int V_PARTS = (BKV / VK) * DC;          // V stages a warpgroup takes per KV tile
constexpr int KSTEPS = BKV / 8;                   // k steps of P V per KV tile
constexpr int FRAG_FLOATS = KSTEPS * 128 * 4;     // P's A fragments of a KV tile: 16 KB
// Where the products are summed.  The tensor cores add into their fp32
// accumulators with truncation (round toward zero), an error of up to an ulp
// of the sum at every wgmma, all of one sign: over the 6144 wgmmas of P V at
// Skv = 16384 that is far above fp32's error.  So the products of a group (S:
// a panel's; P V: a V stage's) land in a fresh accumulator, the two small
// products first, which is added into the sum in registers with an fp32 add
// that rounds to nearest.
constexpr int P_STAGES = 2;
constexpr int P_BYTES = BQ * BKV * 4;
constexpr int STAT_BYTES = BQ * 4;
constexpr int THREADS = 128 * (1 + PV_GROUPS);
constexpr int N_BARS = 2 * QK_STAGES + 2 * PV_GROUPS * V_STAGES + 2 * P_STAGES;
constexpr int SMEM_BYTES = 1024 + QK_STAGES * QK_STAGE + PV_GROUPS * V_STAGES * V_STAGE +
                           P_STAGES * (P_BYTES + STAT_BYTES) + 8 * N_BARS;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(SMEM_BYTES <= 232448, "more shared memory than a block may have");

struct Args {
  float* out;     // [B, Sq, H, D]
  float* frags;   // per block: P's A fragments of every KV tile of its tile, [kv tiles][16 KB]
  float* alphas;  // per block: the rows' rescale factors of every KV tile, [kv tiles][64]
  int H, Sq, Skv, q_tiles, tiles;
  float scale_log2e;
};

// P's word (row, col) in a buffer: the 4-word group XORed by row & 7.
__device__ __forceinline__ uint32_t p_word(int row, int col) {
  return row * BKV + (col ^ ((row & 7) << 2));
}

__global__ void __launch_bounds__(THREADS, 1)
flash_d512_tf32x3_kernel(const __grid_constant__ CUtensorMap map_qh,
                         const __grid_constant__ CUtensorMap map_ql,
                         const __grid_constant__ CUtensorMap map_kh,
                         const __grid_constant__ CUtensorMap map_kl,
                         const __grid_constant__ CUtensorMap map_vh,
                         const __grid_constant__ CUtensorMap map_vl, const Args p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t qk_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t v_smem = qk_smem + QK_STAGES * QK_STAGE;
  const uint32_t p_smem = v_smem + PV_GROUPS * V_STAGES * V_STAGE;
  const uint32_t stat_smem = p_smem + P_STAGES * P_BYTES;
  const uint32_t bars = stat_smem + P_STAGES * STAT_BYTES;
  auto full_qk = [&](int s) { return bars + 8 * s; };
  auto empty_qk = [&](int s) { return bars + 8 * (QK_STAGES + s); };
  // s: stage of PV warpgroup g's ring, g * V_STAGES + stage
  auto full_v = [&](int s) { return bars + 8 * (2 * QK_STAGES + s); };
  auto empty_v = [&](int s) { return bars + 8 * (2 * QK_STAGES + PV_GROUPS * V_STAGES + s); };
  auto full_p = [&](int s) { return bars + 8 * (2 * QK_STAGES + 2 * PV_GROUPS * V_STAGES + s); };
  auto empty_p = [&](int s) {
    return bars + 8 * (2 * QK_STAGES + 2 * PV_GROUPS * V_STAGES + P_STAGES + s);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tid = threadIdx.x & 127;
  const int loader = tid == 0;
  const int kv_tiles = p.Skv / BKV;
  // Thread (w, lane) of a warpgroup holds rows 16w + lane / 4 and + 8 of a
  // wgmma result, columns 8g + 2(lane % 4), + 1 of them in d[4g .. 4g + 3].
  const int row = 16 * (warp & 3) + (lane >> 2), quad = lane & 3;

  if (threadIdx.x == 0) {
    for (int s = 0; s < QK_STAGES; ++s) {
      mbar_init(full_qk(s), 1);   // the loader's expect_tx
      mbar_init(empty_qk(s), 4);  // lane 0 of every softmax warp
    }
    for (int s = 0; s < PV_GROUPS * V_STAGES; ++s) {
      mbar_init(full_v(s), 1);
      mbar_init(empty_v(s), 4);  // lane 0 of every warp of the ring's warpgroup
    }
    for (int s = 0; s < P_STAGES; ++s) {
      mbar_init(full_p(s), 128);             // every softmax thread, after its writes
      mbar_init(empty_p(s), 4 * PV_GROUPS);  // lane 0 of every PV warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tile t -> (batch * H + head, first q row), q tile fastest.
  auto tile_at = [&](int t, int& bh, int& q0) {
    bh = t / p.q_tiles;
    q0 = (t - bh * p.q_tiles) * BQ;
  };
  // Where a warpgroup's loads stand in its ring: the stage and phase to load
  // next and the (tile, KV tile, part) that goes there (PV: and the pass); it
  // runs on from tile to tile.
  int ld_s = 0, ld_ph = 0, ld_t = blockIdx.x, ld_j = 0, ld_part = 0, ld_bh = 0, ld_q0 = 0;
  if (ld_t < p.tiles) tile_at(ld_t, ld_bh, ld_q0);

  if (warp < 4) {
    // The softmax warpgroup: S = Q K^T of a KV tile, the online softmax, then
    // P and the rows' rescale factors to the PV warpgroups.
    auto load_qk = [&]() {  // the next panel of Q and K, hi and lo
      if (ld_t >= p.tiles) return;
      mbar_wait(empty_qk(ld_s), ld_ph ^ 1);
      const uint32_t stage = qk_smem + ld_s * QK_STAGE, bar = full_qk(ld_s);
      const int col = ld_part * PANEL, key = ld_j * BKV;
      mbar_expect_tx_if(loader, bar, QK_STAGE);
      tma_load_3d_if(loader, stage, &map_qh, bar, col, ld_q0, ld_bh);
      tma_load_3d_if(loader, stage + TILE_BYTES, &map_ql, bar, col, ld_q0, ld_bh);
      tma_load_3d_if(loader, stage + K_OFFSET, &map_kh, bar, col, key, ld_bh);
      tma_load_3d_if(loader, stage + K_OFFSET + TILE_BYTES, &map_kl, bar, col, key, ld_bh);
      if (++ld_s == QK_STAGES) ld_s = 0, ld_ph ^= 1;
      if (++ld_part < PANELS) return;
      ld_part = 0;
      if (++ld_j < kv_tiles) return;
      ld_j = 0;
      ld_t += gridDim.x;
      if (ld_t < p.tiles) tile_at(ld_t, ld_bh, ld_q0);
    };
    for (int i = 0; i < QK_STAGES - 1; ++i) load_qk();

    int ks = 0, kp = 0;
    unsigned msg = 0;  // messages sent: buffer msg & 1, its phase (msg >> 1) & 1
    float score[BKV / 2], s[BKV / 2];  // the scores, and a panel's products
    auto claim = [&]() {  // wait until the PV warpgroups have read the buffer
      mbar_wait(empty_p(msg & 1), ((msg >> 1) & 1) ^ 1);
      return static_cast<int>(msg & 1);
    };
    auto send = [&](int buf, float stat0, float stat1) {
      if (quad == 0) {
        const uint32_t addr = stat_smem + buf * STAT_BYTES + row * 4;
        asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(stat0) : "memory");
        asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr + 32), "f"(stat1) : "memory");
      }
      mbar_arrive(full_p(buf));
      ++msg;
    };
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      float m_run[2] = {-1e30f, -1e30f}, l_part[2] = {0.f, 0.f};
      for (int j = 0; j < kv_tiles; ++j) {
        // S = Q K(j)^T: one wgmma group per panel into a fresh accumulator,
        // which is waited for, handed back and added into the scores (reading
        // it while another group is in flight serialises every wgmma, C7514).
#pragma unroll 1
        for (int pn = 0; pn < PANELS; ++pn) {
          mbar_wait(full_qk(ks), kp);
          const uint32_t stage = qk_smem + ks * QK_STAGE;
          const uint64_t dqh = smem_desc(stage), dql = smem_desc(stage + TILE_BYTES);
          const uint64_t dkh = smem_desc(stage + K_OFFSET);
          const uint64_t dkl = smem_desc(stage + K_OFFSET + TILE_BYTES);
          // After the wait's loop, before the group (hopper.cuh: without its
          // own fence here ptxas serialises every wgmma, C7520).
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_tf32_ss(s, dql + 2 * kk, dkh + 2 * kk, kk > 0);
            wgmma_tf32_ss(s, dqh + 2 * kk, dkl + 2 * kk);
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_tf32_ss(s, dqh + 2 * kk, dkh + 2 * kk);
          wgmma_commit();
          wgmma_wait<0>();
          if (lane == 0) mbar_arrive(empty_qk(ks));
          load_qk();
#pragma unroll
          for (int i = 0; i < BKV / 2; ++i) score[i] = pn > 0 ? score[i] + s[i] : s[i];
          if (++ks == QK_STAGES) ks = 0, kp ^= 1;
        }

        // The online softmax: the scores become P, in the log2 domain.
        float mx[2] = {m_run[0], m_run[1]}, alpha[2];
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          score[i] *= p.scale_log2e;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], score[i]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[r] = exp2f(m_run[r] - mx[r]);
          m_run[r] = mx[r];
          l_part[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          const int r = (i >> 1) & 1;
          score[i] = exp2f(score[i] - mx[r]);
          l_part[r] += score[i];
        }
        // P in fp32, rows row and row + 8, keys 8g + 2 quad and + 1.
        const int buf = claim();
        const uint32_t pbuf = p_smem + buf * P_BYTES;
#pragma unroll
        for (int g = 0; g < BKV / 8; ++g)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                             pbuf + 4 * p_word(row + 8 * h, 8 * g + 2 * quad)),
                         "f"(score[4 * g + 2 * h]), "f"(score[4 * g + 2 * h + 1])
                         : "memory");
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
    // The PV warpgroups, in two passes over the KV tiles of a q tile: in pass
    // h warpgroup wg owns columns 256 h + 128 wg .. + 127 of O for all 64
    // rows (2 x 32 accumulators, with the fresh one and a stage's fragments
    // within the 168 registers a thread has) and loads
    // those rows of V^T.  Pass 0 takes P and the rescale factors from the
    // softmax warpgroup's messages and warpgroup 0 writes them out to this
    // block's scratch (P as A fragments, 16 bytes a thread and k step); pass
    // 1 reads them back.
    const int wg = (warp >> 2) - 1, w = warp & 3;
    const uint32_t v_ring = v_smem + wg * V_STAGES * V_STAGE;
    float* const frags = p.frags + (long long)blockIdx.x * kv_tiles * FRAG_FLOATS;
    float* const alphas = p.alphas + (long long)blockIdx.x * kv_tiles * BQ;
    int ld_pass = 0;
    auto load_v = [&]() {  // the next stage: 32 keys x 64 columns of V^T, hi and lo
      if (ld_t >= p.tiles) return;
      const int s = wg * V_STAGES + ld_s;
      mbar_wait(empty_v(s), ld_ph ^ 1);
      const uint32_t stage = v_ring + ld_s * V_STAGE;
      const int key = ld_j * BKV + (ld_part / DC) * VK;
      const int col = (D / PASSES) * ld_pass + COLS * wg + 64 * (ld_part % DC);
      mbar_expect_tx_if(loader, full_v(s), V_STAGE);
      tma_load_3d_if(loader, stage, &map_vh, full_v(s), key, col, ld_bh);
      tma_load_3d_if(loader, stage + TILE_BYTES, &map_vl, full_v(s), key, col, ld_bh);
      if (++ld_s == V_STAGES) ld_s = 0, ld_ph ^= 1;
      if (++ld_part < V_PARTS) return;
      ld_part = 0;
      if (++ld_j < kv_tiles) return;
      ld_j = 0;
      if (++ld_pass < PASSES) return;
      ld_pass = 0;
      ld_t += gridDim.x;
      if (ld_t < p.tiles) tile_at(ld_t, ld_bh, ld_q0);
    };
    for (int i = 0; i < V_STAGES - 1; ++i) load_v();

    int vs = 0, vp = 0;
    unsigned msg = 0;
    float o[DC][32], part[32];
    auto receive = [&](float& stat0, float& stat1) {
      const int buf = msg & 1;
      mbar_wait(full_p(buf), (msg >> 1) & 1);
      const uint32_t addr = stat_smem + buf * STAT_BYTES + row * 4;
      asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(stat0) : "r"(addr) : "memory");
      asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(stat1) : "r"(addr + 32) : "memory");
      ++msg;
      return buf;
    };
    // P's fragments of k step ks of KV tile j in the scratch: 16 bytes a thread.
    auto frag_at = [&](int j, int ks) {
      return reinterpret_cast<float4*>(frags + ((long long)j * KSTEPS + ks) * 512 +
                                       (w * 32 + lane) * 4);
    };
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      int bh, q0;
      tile_at(t, bh, q0);
      float inv0 = 0.f, inv1 = 0.f;
#pragma unroll
      for (int pass = 0; pass < PASSES; ++pass) {
#pragma unroll
        for (int c = 0; c < DC; ++c)
#pragma unroll
          for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
        for (int j = 0; j < kv_tiles; ++j) {
          float a0, a1;
          int buf = 0;
          if (pass == 0) {
            buf = receive(a0, a1);
            if (wg == 0 && quad == 0) alphas[j * BQ + row] = a0, alphas[j * BQ + row + 8] = a1;
          } else {
            a0 = __ldcg(alphas + j * BQ + row), a1 = __ldcg(alphas + j * BQ + row + 8);
          }
#pragma unroll
          for (int c = 0; c < DC; ++c)
#pragma unroll
            for (int i = 0; i < 32; i += 4) {
              o[c][i] *= a0, o[c][i + 1] *= a0;
              o[c][i + 2] *= a1, o[c][i + 3] *= a1;
            }
          const uint32_t pbuf = p_smem + buf * P_BYTES;
          // O += P V(j): per 32 keys P's fragments for their four k steps,
          // split once, then per 64 columns a stage of V^T.
#pragma unroll
          for (int kb = 0; kb < BKV / VK; ++kb) {
            uint32_t hi[4][4], lo[4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const int ks = kb * 4 + kk;
              float4 f;
              if (pass == 0) {  // a[e]: row + 8 (e & 1), key 8 ks + quad + 4 (e >> 1)
                float v[4];
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  asm volatile("ld.shared.f32 %0, [%1];\n"
                               : "=f"(v[e])
                               : "r"(pbuf + 4 * p_word(row + 8 * (e & 1),
                                                       8 * ks + quad + 4 * (e >> 1)))
                               : "memory");
                f = make_float4(v[0], v[1], v[2], v[3]);
                if (wg == 0) __stcg(frag_at(j, ks), f);
              } else {
                f = __ldcg(frag_at(j, ks));
              }
              split(f.x, hi[kk][0], lo[kk][0]);
              split(f.y, hi[kk][1], lo[kk][1]);
              split(f.z, hi[kk][2], lo[kk][2]);
              split(f.w, hi[kk][3], lo[kk][3]);
            }
#pragma unroll
            for (int c = 0; c < DC; ++c) {
              const int s = wg * V_STAGES + vs;
              mbar_wait(full_v(s), vp);
              const uint64_t dvh = smem_desc(v_ring + vs * V_STAGE);
              const uint64_t dvl = smem_desc(v_ring + vs * V_STAGE + TILE_BYTES);
              wgmma_fence();
              // a fresh accumulator, the small products first
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                wgmma_tf32_rs(part, lo[kk], dvh + 2 * kk, kk > 0);
                wgmma_tf32_rs(part, hi[kk], dvl + 2 * kk);
              }
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) wgmma_tf32_rs(part, hi[kk], dvh + 2 * kk);
              wgmma_commit();
              wgmma_wait<0>();
#pragma unroll
              for (int i = 0; i < 32; ++i) o[c][i] += part[i];
              if (lane == 0) mbar_arrive(empty_v(s));
              load_v();
              if (++vs == V_STAGES) vs = 0, vp ^= 1;
            }
          }
          if (pass == 0) {
            __syncwarp();
            if (lane == 0) mbar_arrive(empty_p(buf));
          }
        }
        if (pass == 0) {
          const int buf = receive(inv0, inv1);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty_p(buf));
        }
        // O / l from the registers: rows q0 + row (+ 8), columns 256 pass +
        // 128 wg + 64 c + 8 g + 2 quad, + 1.
        const int b = bh / p.H, h = bh - b * p.H;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float inv = hh ? inv1 : inv0;
          float* orow = p.out + (((long long)b * p.Sq + q0 + row + 8 * hh) * p.H + h) * D +
                        (D / PASSES) * pass + COLS * wg;
#pragma unroll
          for (int c = 0; c < DC; ++c)
#pragma unroll
            for (int g = 0; g < 8; ++g)
              *reinterpret_cast<float2*>(orow + 64 * c + 8 * g + 2 * quad) =
                  make_float2(o[c][4 * g + 2 * hh] * inv, o[c][4 * g + 2 * hh + 1] * inv);
        }
        // Warpgroup 0's fragments of pass 0 are read by both in pass 1, and
        // pass 1's reads end before the next tile's pass 0 writes again.
        __threadfence_block();
        named_barrier(1, 128 * PV_GROUPS);
      }
    }
  }
}

// ---------------------------------------------------------------- D = 64

namespace d64 {

constexpr int D = 64, BQ = 128, BKV = 64;
constexpr int PANEL = 32;              // columns (Q, K) or keys (V^T) of a box: 128 bytes
constexpr int CONSUMERS = 2;           // warpgroups, 64 q rows each
constexpr int THREADS = 128 * CONSUMERS + 32;
constexpr int Q_PANEL = BQ * 128;      // 128 q rows x 32 columns: 16 KB
constexpr int Q_COPY = 2 * Q_PANEL;    // Q hi or lo: two panels
constexpr int TILE = 64 * 128;         // 64 rows of 128 bytes: 8 KB
constexpr int HALF = 2 * TILE;         // K: two panels of 64 keys; V^T: 64 columns x two boxes
constexpr int STAGE = 2 * HALF;        // hi and lo: 32 KB
constexpr int STAGES = 5;              // K(j), V(j), K(j + 1), ... in turn
constexpr int SMEM_BYTES = 1024 + 2 * Q_COPY + STAGES * STAGE + 8 * (2 + 2 * STAGES);
static_assert(SMEM_BYTES <= 232448, "more shared memory than a block may have");

struct Args {
  float* out;  // [B, Sq, H, D]
  int H, Sq, Skv, q_tiles, tiles;
  float scale_log2e;
};

// d = (Q K^T) of one panel of 32 columns, four k steps into a fresh
// accumulator, the small products first.
__device__ __forceinline__ void s_panel(float (&d)[32], uint64_t dqh, uint64_t dql, uint64_t dkh,
                                        uint64_t dkl) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_tf32_ss(d, dql + 2 * kk, dkh + 2 * kk, kk > 0);
    wgmma_tf32_ss(d, dqh + 2 * kk, dkl + 2 * kk);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_tf32_ss(d, dqh + 2 * kk, dkh + 2 * kk);
}

// d = P V of 32 keys (k steps k0 .. k0 + 3 of P's fragments) against a box of
// V^T, into a fresh accumulator, the small products first.
template <int K0>
__device__ __forceinline__ void pv_box(float (&d)[32], const uint32_t (&hi)[8][4],
                                       const uint32_t (&lo)[8][4], uint64_t dvh, uint64_t dvl) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_tf32_rs(d, lo[K0 + kk], dvh + 2 * kk, kk > 0);
    wgmma_tf32_rs(d, hi[K0 + kk], dvl + 2 * kk);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_tf32_rs(d, hi[K0 + kk], dvh + 2 * kk);
}

__global__ void __launch_bounds__(THREADS, 1)
flash_d64_tf32x3_kernel(const __grid_constant__ CUtensorMap map_qh,
                        const __grid_constant__ CUtensorMap map_ql,
                        const __grid_constant__ CUtensorMap map_kh,
                        const __grid_constant__ CUtensorMap map_kl,
                        const __grid_constant__ CUtensorMap map_vh,
                        const __grid_constant__ CUtensorMap map_vl, const Args p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_smem = q_smem + 2 * Q_COPY;
  const uint32_t bars = kv_smem + STAGES * STAGE;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto full = [&](int s) { return bars + 16 + 8 * s; };
  auto empty = [&](int s) { return bars + 16 + 8 * (STAGES + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kv_tiles = p.Skv / BKV;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);                // the producer's expect_tx
    mbar_init(q_empty, 4 * CONSUMERS);   // lane 0 of every consumer warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tile t -> (batch * H + head, first q row), q tile fastest.
  auto tile_at = [&](int t, int& bh, int& q0) {
    bh = t / p.q_tiles;
    q0 = (t - bh * p.q_tiles) * BQ;
  };

  if (warp == 4 * CONSUMERS) {
    // Producer: a tile's Q once the consumers are done with the last one's,
    // then K(j) and V(j) of every KV tile through the ring.
    if (lane != 0) return;
    int s = 0, ph = 0, qph = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      int bh, q0;
      tile_at(t, bh, q0);
      mbar_wait(q_empty, qph ^ 1);
      mbar_expect_tx(q_full, 2 * Q_COPY);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        tma_load_3d(q_smem + c * Q_PANEL, &map_qh, q_full, c * PANEL, q0, bh);
        tma_load_3d(q_smem + Q_COPY + c * Q_PANEL, &map_ql, q_full, c * PANEL, q0, bh);
      }
      qph ^= 1;
      for (int j = 0; j < kv_tiles; ++j) {
        // K(j): two panels of 32 columns; V(j)^T: two boxes of 32 keys
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          mbar_wait(empty(s), ph ^ 1);
          const uint32_t st = kv_smem + s * STAGE;
          mbar_expect_tx(full(s), STAGE);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            if (kv == 0) {
              tma_load_3d(st + c * TILE, &map_kh, full(s), c * PANEL, j * BKV, bh);
              tma_load_3d(st + HALF + c * TILE, &map_kl, full(s), c * PANEL, j * BKV, bh);
            } else {
              tma_load_3d(st + c * TILE, &map_vh, full(s), j * BKV + c * PANEL, 0, bh);
              tma_load_3d(st + HALF + c * TILE, &map_vl, full(s), j * BKV + c * PANEL, 0, bh);
            }
          }
          if (++s == STAGES) s = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns q rows 64 wg .. + 63 of the tile; thread
  // (w, lane) holds rows 16w + lane / 4 and + 8 of a wgmma result, columns 8g
  // + 2 quad, + 1 in d[4g .. 4g + 3].
  const int wg = warp >> 2, row = 16 * (warp & 3) + (lane >> 2), quad = lane & 3;
  const uint32_t q_rows = q_smem + wg * TILE;  // this warpgroup's 64 rows of a Q panel
  int s = 0, ph = 0, qph = 0;
  float o[32], score[32], part[32];
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    int bh, q0;
    tile_at(t, bh, q0);
    mbar_wait(q_full, qph);
    qph ^= 1;
    float m_run[2] = {-1e30f, -1e30f}, l_part[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    for (int j = 0; j < kv_tiles; ++j) {
      // S = Q K(j)^T: a fresh accumulator per panel of 32 columns (score
      // itself for the first), added with an fp32 add.
      mbar_wait(full(s), ph);
      const uint32_t kst = kv_smem + s * STAGE;
      wgmma_fence();  // after the wait's loop, before the group (C7520)
      s_panel(score, smem_desc(q_rows), smem_desc(q_rows + Q_COPY), smem_desc(kst),
              smem_desc(kst + HALF));
      s_panel(part, smem_desc(q_rows + Q_PANEL), smem_desc(q_rows + Q_COPY + Q_PANEL),
              smem_desc(kst + TILE), smem_desc(kst + HALF + TILE));
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) {
        mbar_arrive(empty(s));
        if (j == kv_tiles - 1) mbar_arrive(q_empty);  // this tile's Q is read
      }
      if (++s == STAGES) s = 0, ph ^= 1;
#pragma unroll
      for (int i = 0; i < 32; ++i) score[i] += part[i];

      // The online softmax: the scores become P, in the log2 domain.
      float mx[2] = {m_run[0], m_run[1]}, alpha[2];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        score[i] *= p.scale_log2e;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], score[i]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f(m_run[r] - mx[r]);
        m_run[r] = mx[r];
        l_part[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        score[i] = exp2f(score[i] - mx[r]);
        l_part[r] += score[i];
        o[i] *= alpha[r];
      }
      // P's A fragments straight from the accumulators: this thread holds keys
      // 8 kb + 2 quad and + 1 of k step kb, which V^T's prologue put in slots
      // quad and quad + 4 of that k step (a[0], a[1]: rows row and row + 8 at
      // slot quad; a[2], a[3] at slot quad + 4).
      uint32_t phi[8][4], plo[8][4];
#pragma unroll
      for (int kb = 0; kb < 8; ++kb) {
        split(score[4 * kb], phi[kb][0], plo[kb][0]);
        split(score[4 * kb + 2], phi[kb][1], plo[kb][1]);
        split(score[4 * kb + 1], phi[kb][2], plo[kb][2]);
        split(score[4 * kb + 3], phi[kb][3], plo[kb][3]);
      }
      // O += P V(j): per box of 32 keys a fresh accumulator, added with an
      // fp32 add.
      mbar_wait(full(s), ph);
      const uint32_t vst = kv_smem + s * STAGE;
      wgmma_fence();
      pv_box<0>(part, phi, plo, smem_desc(vst), smem_desc(vst + HALF));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] += part[i];
      wgmma_fence();
      pv_box<4>(part, phi, plo, smem_desc(vst + TILE), smem_desc(vst + HALF + TILE));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] += part[i];
      if (lane == 0) mbar_arrive(empty(s));
      if (++s == STAGES) s = 0, ph ^= 1;
    }
    // O / l from the registers: rows q0 + 64 wg + row (+ 8), columns 8g + 2
    // quad, + 1.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_part[r] += __shfl_xor_sync(0xffffffffu, l_part[r], 1);
      l_part[r] += __shfl_xor_sync(0xffffffffu, l_part[r], 2);
    }
    const int b = bh / p.H, h = bh - b * p.H;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float inv = 1.f / l_part[hh];
      float* orow =
          p.out + (((long long)b * p.Sq + q0 + 64 * wg + row + 8 * hh) * p.H + h) * D;
#pragma unroll
      for (int g = 0; g < 8; ++g)
        *reinterpret_cast<float2*>(orow + 8 * g + 2 * quad) =
            make_float2(o[4 * g + 2 * hh] * inv, o[4 * g + 2 * hh + 1] * inv);
    }
  }
}

}  // namespace d64

// Q and K as TF32 hi and lo copies [B*H, S, D], V as hi and lo copies of V^T
// [B*H, D, S]: blockIdx.z = tensor (0 q, 1 k, 2 v) x B*H + b*H + head, a
// block a tile of 32 rows x 32 columns (through shared memory for V^T).  With
// `perm`, V^T's keys are written in the order the D = 64 kernel's P fragments
// take them: key 8g + r at 8g + r / 2 + 4 (r % 2).
struct SplitArgs {
  const float* src[3];
  float* hi[3];
  float* lo[3];
  long long sb[3], ss[3];  // batch and row strides of q, k, v, in elements
  int H, D, S[3], perm;
};

__global__ void __launch_bounds__(256) split_qkv_tf32_kernel(const SplitArgs a) {
  __shared__ float tile[2][32][33];
  const int bhs = gridDim.z / 3, which = blockIdx.z / bhs, bh = blockIdx.z - which * bhs;
  const int S = a.S[which], D = a.D, s0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  if (s0 >= S) return;
  const int b = bh / a.H, h = bh - b * a.H, tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const float* src = a.src[which] + b * a.sb[which] + (long long)h * D;
  for (int i = ty; i < 32; i += 8) {
    uint32_t hi, lo;
    const float x = src[(long long)(s0 + i) * a.ss[which] + d0 + tx];
    split(x, hi, lo);
    if (which < 2) {
      const long long at = ((long long)bh * S + s0 + i) * D + d0 + tx;
      a.hi[which][at] = __uint_as_float(hi);
      a.lo[which][at] = __uint_as_float(lo);
    } else {
      tile[0][i][tx] = __uint_as_float(hi);
      tile[1][i][tx] = __uint_as_float(lo);
    }
  }
  if (which < 2) return;
  __syncthreads();
  const int slot = a.perm ? (tx & ~7) + ((tx & 7) >> 1) + 4 * (tx & 1) : tx;
  for (int i = ty; i < 32; i += 8) {
    const long long at = ((long long)bh * D + d0 + i) * S + s0 + slot;
    a.hi[2][at] = tile[0][tx][i];
    a.lo[2][at] = tile[1][tx][i];
  }
}

// A 3-D fp32 map over [planes, rows, inner] (inner contiguous), box 32 x
// box_rows.
int encode_3d(CUtensorMap* map, const float* base, long long planes, long long rows,
              long long inner, int box_rows = 64) {
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 4, (cuuint64_t)(rows * inner) * 4};
  const cuuint32_t box[3] = {PANEL, (cuuint32_t)box_rows, 1};
  return encode_map_f32(map, base, 3, dims, strides, box);
}

// The prologue of both attention calls: the split launch into the front of
// `scratch` (Q, K and V^T, hi then lo, each after the last), and the six
// tensor maps over the copies (Q's boxes q_rows x 32, K's and V^T's 64 x 32);
// `end` is where the copies end.  0 or a CUDA error.
int split_and_map(const void* q, const void* k, const void* v, float* scratch, int B, int H,
                  int Sq, int Skv, int D, int perm, const long long (&sb)[3],
                  const long long (&ss)[3], int q_rows, CUtensorMap (&maps)[6], float*& end,
                  cudaStream_t s) {
  const long long bh = (long long)B * H, q_n = bh * Sq * D, kv_n = bh * Skv * D;
  SplitArgs sa{};
  const void* src[3] = {q, k, v};
  float* at = scratch;
  for (int i = 0; i < 3; ++i) {
    const long long n = i == 0 ? q_n : kv_n;
    sa.src[i] = static_cast<const float*>(src[i]);
    sa.hi[i] = at, sa.lo[i] = at + n, at += 2 * n;
    sa.sb[i] = sb[i], sa.ss[i] = ss[i];
    sa.S[i] = i == 0 ? Sq : Skv;
  }
  sa.H = H, sa.D = D, sa.perm = perm;
  end = at;
  const int longest = Sq > Skv ? Sq : Skv;
  split_qkv_tf32_kernel<<<dim3(longest / 32, D / 32, (unsigned)(3 * bh)), 256, 0, s>>>(sa);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  int err = 0;
  for (int i = 0; i < 2 && err == 0; ++i) {  // Q, K: [B*H, S, D]
    const int rows = i == 0 ? q_rows : 64;
    err = encode_3d(&maps[2 * i], sa.hi[i], bh, sa.S[i], D, rows);
    if (err == 0) err = encode_3d(&maps[2 * i + 1], sa.lo[i], bh, sa.S[i], D, rows);
  }
  if (err == 0) err = encode_3d(&maps[4], sa.hi[2], bh, D, Skv);  // V^T: [B*H, D, Skv]
  if (err == 0) err = encode_3d(&maps[5], sa.lo[2], bh, D, Skv);
  return err;
}

bool aligned(const void* q, const void* k, const void* v, const void* out, const void* scratch,
             long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long v_sb,
             long long v_ss) {
  return ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
           reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
           reinterpret_cast<uintptr_t>(scratch)) % 16 == 0) &&
         ((q_sb | q_ss | k_sb | k_ss | v_sb | v_ss) % 4 == 0);
}

}  // namespace

// What the host-side plan (ops/flash_attention.plan_f32 at D = 512) mirrors:
// which = 1 the KV tile, 2 the Q/K ring's stages, 3 the dynamic shared memory
// in bytes, 4 the V ring's stages (per PV warpgroup), 5 the keys of a V
// stage, 6 the q tile, 7 the scratch floats a block takes per KV tile (P's
// fragments and the rescale factors); -1 otherwise.
extern "C" int flash_d512_tf32x3_geometry(int which) {
  switch (which) {
    case 1: return BKV;
    case 2: return QK_STAGES;
    case 3: return SMEM_BYTES;
    case 4: return V_STAGES;
    case 5: return VK;
    case 6: return BQ;
    case 7: return FRAG_FLOATS + BQ;
    default: return -1;
  }
}

// What the host-side plan (ops/flash_attention.plan_f32 at D = 64) mirrors:
// which = 1 the KV tile, 2 the ring's stages (K and V tiles in turn), 3 the
// dynamic shared memory in bytes, 6 the q tile; -1 otherwise.
extern "C" int flash_d64_tf32x3_geometry(int which) {
  switch (which) {
    case 1: return d64::BKV;
    case 2: return d64::STAGES;
    case 3: return d64::SMEM_BYTES;
    case 6: return d64::BQ;
    default: return -1;
  }
}

// q [B, Sq, H, 512], k and v [B, Skv, H, 512] fp32 with contiguous heads and
// the given batch and row strides (elements; multiples of 4, 16-byte aligned
// bases) -> out [B, Sq, H, 512] fp32, contiguous.  scratch: 2 * B * H * (Sq +
// 2 Skv) * 512 floats for the hi and lo copies of Q, K and V^T, then grid *
// Skv / 64 * (4096 + 64) for each block's P fragments and rescale factors
// (flash_d512_tf32x3_geometry(7): the floats per block and KV tile).  Sq and Skv
// multiples of 64; grid persistent blocks from the plan.  Two launches: the
// split, then the attention.
extern "C" int flash_attention_d512_tf32x3(const void* q, const void* k, const void* v,
                                           void* out, void* scratch, int B, int H, int Sq,
                                           int Skv, long long q_sb, long long q_ss,
                                           long long k_sb, long long k_ss, long long v_sb,
                                           long long v_ss, float scale, int grid,
                                           void* stream) {
  if (B < 1 || H < 1 || Sq < BQ || Skv < BKV || Sq % BQ || Skv % BKV || grid < 1 ||
      !aligned(q, k, v, out, scratch, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss) ||
      (long long)B * H * 3 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  static unsigned long long configured = 0;
  if (int err = allow_smem(flash_d512_tf32x3_kernel, SMEM_BYTES, configured)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap maps[6];
  float* at = nullptr;
  if (int err = split_and_map(q, k, v, static_cast<float*>(scratch), B, H, Sq, Skv, D, 0,
                              {q_sb, k_sb, v_sb}, {q_ss, k_ss, v_ss}, 64, maps, at, s))
    return err;
  Args a{};
  a.out = static_cast<float*>(out);
  a.frags = at;
  a.alphas = at + (long long)grid * (Skv / BKV) * FRAG_FLOATS;
  a.H = H, a.Sq = Sq, a.Skv = Skv, a.q_tiles = Sq / BQ;
  a.tiles = (int)((long long)B * H * (Sq / BQ));
  a.scale_log2e = scale * LOG2E;
  flash_d512_tf32x3_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(maps[0], maps[1], maps[2],
                                                             maps[3], maps[4], maps[5], a);
  return static_cast<int>(cudaGetLastError());
}

// q [B, Sq, H, 64], k and v [B, Skv, H, 64] fp32 with contiguous heads and the
// given batch and row strides (elements; multiples of 4, 16-byte aligned
// bases) -> out [B, Sq, H, 64] fp32, contiguous.  scratch: 2 * B * H * (Sq + 2
// Skv) * 64 floats for the hi and lo copies of Q, K and V^T (V^T's keys in P's
// fragment order).  Sq a multiple of 128, Skv of 64; grid persistent blocks
// from the plan.  Two launches: the split, then the attention.
extern "C" int flash_attention_d64_tf32x3(const void* q, const void* k, const void* v,
                                          void* out, void* scratch, int B, int H, int Sq,
                                          int Skv, long long q_sb, long long q_ss,
                                          long long k_sb, long long k_ss, long long v_sb,
                                          long long v_ss, float scale, int grid,
                                          void* stream) {
  if (B < 1 || H < 1 || Sq < d64::BQ || Skv < d64::BKV || Sq % d64::BQ || Skv % d64::BKV ||
      grid < 1 || !aligned(q, k, v, out, scratch, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss) ||
      (long long)B * H * 3 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  static unsigned long long configured = 0;
  if (int err = allow_smem(d64::flash_d64_tf32x3_kernel, d64::SMEM_BYTES, configured))
    return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap maps[6];
  float* at = nullptr;
  if (int err = split_and_map(q, k, v, static_cast<float*>(scratch), B, H, Sq, Skv, d64::D, 1,
                              {q_sb, k_sb, v_sb}, {q_ss, k_ss, v_ss}, d64::BQ, maps, at, s))
    return err;
  d64::Args a{};
  a.out = static_cast<float*>(out);
  a.H = H, a.Sq = Sq, a.Skv = Skv, a.q_tiles = Sq / d64::BQ;
  a.tiles = (int)((long long)B * H * (Sq / d64::BQ));
  a.scale_log2e = scale * LOG2E;
  d64::flash_d64_tf32x3_kernel<<<grid, d64::THREADS, d64::SMEM_BYTES, s>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], a);
  return static_cast<int>(cudaGetLastError());
}
