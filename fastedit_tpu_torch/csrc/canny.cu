// Canny prepare on the card: the edge map of ControlNet-Canny and the VAE
// input, in one launch with no host synchronisation, so a CUDA graph captures
// the whole of prepare.
//
// Serves the JAX package's prepare (fastedit_tpu/pipeline/stages.py
// `_prepare_one_fn`), which computes Canny in XLA, not in Pallas
// (fastedit_tpu/ops/canny.py `canny_jax`: the stencil part at :42-99, the
// hysteresis, a lax.while_loop of masked dilations to a fixed point, at
// :102-137).  Bit-exact to `canny_np` (and so to cv2 5.0): the shift-15 gray,
// Sobel with a replicate border and the L1 magnitude, cv2's integer NMS
// sectors (TG22 = 13573) and tie rules, the thresholds compared strictly, and
// 8-connected hysteresis.  The VAE input is f / 127.5 - 1 in T (an fp32
// division and subtraction with round-to-nearest, then one rounding to bf16).
//
// One kernel, canny_kernel<T, MODE>, with three entries on the same device
// code:
//   PREPARE     image -> control and VAE input (what an edit launches);
//   FRONT       image -> class map (0 none, 1 weak: a candidate, 2 strong) and
//               VAE input, the union-find skipped;
//   HYSTERESIS  class map -> control, the class map staged instead of computed.
//
// A persistent grid (ops/canny.plan: as many blocks as the card holds at once,
// at most one per tile) walks the 32 x 32 tiles of the batch in three phases:
//   1. per tile (block k's first is tile k, the rest handed out by a counter,
//      so a block that met light tiles takes more): its RGB rows, with a
//      two-pixel halo, staged in shared memory by 16-byte cp.async copies (a
//      two-stage ring: the block's next tile is in flight while this one
//      computes; the replicate border is a clamp of the index into the
//      staged window), then gray, Sobel, the magnitude, NMS
//      and the double threshold from shared memory into a class map that
//      stays there (the hysteresis entry stages the class map's rows the same
//      way instead); the VAE input from the staged bytes through a 256-entry
//      table per block (the same fp32 arithmetic, once per byte value),
//      stored as 16-byte vectors; then the tile-local union-find on the class
//      map in shared memory (a warp per row links each run of candidates to
//      its least node from two ballots; each pair of runs in neighbouring
//      rows that touch is united once, by atomicMin links), and each pixel's
//      label written: a local root its global node id, another candidate its
//      local root, NONE a pixel that is no candidate, so no later phase reads
//      a class map;
//   -- a grid-wide barrier (cooperative launch: every block is resident, or
//      the launch is refused; the spin traps after SPIN_LIMIT_NS) --
//   2. block k's tiles k, k + grid, ...: per tile edge (a warp for the top
//      row, one for the left column, one for
//      the right): each candidate's backward neighbours (W, NW, N, NE) in
//      another tile are united with it on the global labels (atomicMin, finds
//      through L2), a pair skipped where the pixel, or the pixel before it
//      along the edge, already met the same neighbour label;
//   -- a second grid-wide barrier --
//   3. the same tiles, two a round: each local root's root (the other
//      candidates take their local root's from shared memory) and the
//      control (1 where the root is strong) stored as 16-byte vectors of
//      whole pixels.  The last block out sets the counters back to 0 for the
//      next launch (or graph replay).
//
// The node ids make the strong test free: a strong pixel p is node p, a weak
// one node N + p (N pixels in the batch), both kept in slot p of the labels
// (int32 [N]; each pixel has one node).  Every link points to a smaller id, so
// a component's root is its least id, which is strong exactly when the
// component holds a strong pixel.  Every find halves the path it walks, so
// chains stay short.  Atomics order the links by scheduling, so
// the labels differ from run to run; the roots' classes, and so the output,
// do not.
//
// What bounds it on an H100: by its bytes, little.  Per 1024² image prepare
// reads 3 MB of uint8 RGB and writes the VAE input and the control, 6 MB each
// in bf16 (12 in fp32): 4.7 µs at 3.35 TB/s in bf16; the labels (4 MB) stay in
// the 50 MB L2.  What bounds it in practice (PERF.md): the first phase
// is instruction issue and shared-memory latency at five blocks an SM (48
// registers a thread), ~1.5-2 µs a tile a block; the local unions are chains
// of dependent shared-memory steps; the two later phases are chains through
// L2 (the finds and atomicMin links), ~5 µs each at batch 1.  A union's find
// walks a chain of links whose length grows with how many tiles a component
// crosses: a stress image whose one component winds through every tile walks
// the longest ones.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE = 32;                      // a tile's side, pixels
constexpr int TPX = TILE * TILE;              // pixels of a tile
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 5;                 // resident blocks an SM, at least
constexpr int WARPS = THREADS / 32;
constexpr int HALO = 2;                       // Sobel's ring plus NMS's ring
constexpr int GT = TILE + 2 * HALO;           // gray tile side
constexpr int MT = TILE + 2;                  // magnitude tile side
constexpr int ROW_BYTES = 128;                // a staged row: 8 chunks of 16 bytes
constexpr int STAGE_BYTES = GT * ROW_BYTES;   // a tile's staged RGB rows
constexpr int NONE = -1;                      // the label of a pixel that is no candidate
constexpr unsigned long long SPIN_LIMIT_NS = 1000000000ull;

constexpr int GRAY_R = 9798, GRAY_G = 19235, GRAY_B = 3735, GRAY_SHIFT = 15;
constexpr int CANNY_SHIFT = 15, TG22 = 13573;
constexpr uint8_t WEAK = 1, STRONG = 2;

enum : int { PREPARE = 0, FRONT = 1, HYSTERESIS = 2 };

// The raw bits of T, stored as one integer (a 16-byte vector holds 8 or 4).
template <typename T>
struct RawOf;
template <>
struct RawOf<float> {
  using type = uint32_t;
};
template <>
struct RawOf<__nv_bfloat16> {
  using type = uint16_t;
};
template <typename T>
using Raw = typename RawOf<T>::type;

template <typename T>
__device__ __forceinline__ Raw<T> raw_of(float v);
template <>
__device__ __forceinline__ uint32_t raw_of<float>(float v) {
  return __float_as_uint(v);
}
template <>
__device__ __forceinline__ uint16_t raw_of<__nv_bfloat16>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

struct Args {
  const uint8_t* img;     // [B, H, W, 3] (PREPARE, FRONT); 16-byte aligned
  const uint8_t* cls_in;  // [B, H, W] (HYSTERESIS)
  const int* low;         // the thresholds, floored, low <= high (PREPARE, FRONT)
  const int* high;
  uint8_t* cls_out;       // [B, H, W] (FRONT)
  void* vae_in;           // [B, H, W, 3] of T (PREPARE, FRONT)
  void* control;          // [B, H, W, 3] of T (PREPARE, HYSTERESIS)
  int* labels;            // [B, H, W] scratch (PREPARE, HYSTERESIS)
  unsigned int* counter;  // 3, zero before the launch and after it
  int B, H, W;
  int tiles_x, tiles_y;   // per image
  int ntiles;             // of the batch
};

template <typename T>
struct Smem {
  alignas(16) uint8_t ring[2][STAGE_BYTES];  // two tiles' RGB rows
  int rbase[GT];      // staged row r's byte of pixel x: rbase[r] + (bytes a pixel) x
  int gray[GT][GT];
  int mag[MT][MT];    // the magnitude, and in bits 16-17 the gradient's sector
  int lab[TPX];       // tile-local union-find; in phase 3 two tiles' edges
  uint8_t cl[TPX];    // the class map
  Raw<T> table[256];  // the VAE input of each byte value
  int tile[2];        // phase 1: the tile in hand and the next one
};

// A tile: its image, its corner and the index of its first pixel in the
// batch (pixel indices fit int32: the wrapper refuses 2^30 pixels or more).
struct Tile {
  int b, y0, x0, pix0;
};

__device__ __forceinline__ Tile tile_of(const Args& a, int t) {
  const int per_image = a.tiles_x * a.tiles_y;
  const int b = t / per_image, r = t - b * per_image;
  const int ty = r / a.tiles_x;
  const int y0 = ty * TILE, x0 = (r - ty * a.tiles_x) * TILE;
  return {b, y0, x0, (b * a.H + y0) * a.W + x0};
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long v;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(v));
  return v;
}

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// 16 bytes from device memory into shared memory, of which the first `bytes`
// are read and the rest set to 0.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A loop over the elements of a side x side array, THREADS apart, that keeps
// its row and column without a division: f(r, c).
template <int SIDE, typename F>
__device__ __forceinline__ void over_square(F f) {
  constexpr int DR = THREADS / SIDE, DC = THREADS % SIDE;
  int r = threadIdx.x / SIDE, c = threadIdx.x % SIDE;
  for (int i = threadIdx.x; i < SIDE * SIDE; i += THREADS) {
    f(r, c);
    r += DR;
    c += DC;
    if (c >= SIDE) {
      c -= SIDE;
      ++r;
    }
  }
}

// ---------------------------------------------------------------- phase 1

// The byte of image row y's first value in the batch (and the element index
// of its first value in an output).
__device__ __forceinline__ long long row0(const Args& a, int b, int y) {
  return ((long long)b * a.H + y) * a.W * 3;
}

// The byte of staged row r's first value in the batch: image row
// y0 - PAD + r, clamped to the image, BPP bytes a pixel.
template <int BPP, int PAD>
__device__ __forceinline__ long long staged_row(const Args& a, const Tile& tl, int r) {
  return ((long long)tl.b * a.H + clampi(tl.y0 - PAD + r, 0, a.H - 1)) * a.W * BPP;
}

// Tile t's rows y0 - PAD .. y0 + 31 + PAD of `src` (the RGB image with the
// two-pixel halo, or the class map without one) into `dst`, row r at
// dst + r * ROW_BYTES, from the 16-byte chunk that holds pixel
// xs = max(x0 - PAD, 0); the batch's end bounds the last chunk.
template <int BPP, int PAD>
__device__ void stage_rows(const Args& a, const uint8_t* src, int t, uint8_t* dst) {
  const Tile tl = tile_of(a, t);
  const long long total = (long long)a.B * a.H * a.W * BPP;
  const int xs = max(tl.x0 - PAD, 0), xe = min(tl.x0 + TILE + PAD, a.W);
  for (int i = threadIdx.x; i < (TILE + 2 * PAD) * (ROW_BYTES / 16); i += THREADS) {
    const int r = i >> 3, k = i & 7;
    const long long row = staged_row<BPP, PAD>(a, tl, r);
    const long long off = ((row + BPP * xs) & ~15ll) + 16 * k;
    if (off < row + BPP * xe)
      cp_async16(dst + r * ROW_BYTES + 16 * k, src + off, (int)min(16ll, total - off));
  }
}

// Where pixel x lies in staged row r: at row_lead + BPP x.
template <int BPP, int PAD>
__device__ __forceinline__ int row_lead(const Args& a, const Tile& tl, int r) {
  const int xs = max(tl.x0 - PAD, 0);
  return (int)((staged_row<BPP, PAD>(a, tl, r) + BPP * xs) & 15) - BPP * xs;
}

// Gray, Sobel, the magnitude, NMS and the double threshold of one tile, from
// its staged rows into s.cl.  Sobel runs once a pixel: the magnitude pass
// keeps the gradient's NMS sector beside the magnitude.
template <typename T>
__device__ void classes(const Args& a, const Tile& tl, const uint8_t* stage, Smem<T>& s, int lo,
                        int hi) {
  // gray at the tile and its two-pixel halo, the border replicated
  over_square<GT>([&](int r, int c) {
    const int x = clampi(tl.x0 - HALO + c, 0, a.W - 1);
    const uint8_t* p = stage + r * ROW_BYTES + (s.rbase[r] + 3 * x);
    s.gray[r][c] = (p[0] * GRAY_R + p[1] * GRAY_G + p[2] * GRAY_B + (1 << (GRAY_SHIFT - 1))) >>
                   GRAY_SHIFT;
  });
  __syncthreads();

  // L1 magnitude at the tile and a one-pixel ring, 0 outside the image; the
  // sector: 0 horizontal, 1 vertical, 2 the diagonal where gx and gy differ in
  // sign, 3 the other
  over_square<MT>([&](int r, int c) {
    const int y = tl.y0 - 1 + r, x = tl.x0 - 1 + c;
    int v = 0;
    if ((unsigned)y < (unsigned)a.H && (unsigned)x < (unsigned)a.W) {
      const int(*g)[GT] = s.gray;
      const int gx = (g[r][c + 2] - g[r][c]) + 2 * (g[r + 1][c + 2] - g[r + 1][c]) +
                     (g[r + 2][c + 2] - g[r + 2][c]);
      const int gy = (g[r + 2][c] - g[r][c]) + 2 * (g[r + 2][c + 1] - g[r][c + 1]) +
                     (g[r + 2][c + 2] - g[r][c + 2]);
      const int ax = abs(gx), ay = abs(gy) << CANNY_SHIFT;
      const int tg22x = ax * TG22;
      const int tg67x = tg22x + ((2 * ax) << CANNY_SHIFT);
      const int sector = ay < tg22x ? 0 : (ay > tg67x ? 1 : ((gx ^ gy) < 0 ? 2 : 3));
      v = (ax + abs(gy)) | sector << 16;
    }
    s.mag[r][c] = v;
  });
  __syncthreads();

  // NMS along the sector: the first neighbour compared strictly, the second
  // strictly on the diagonals only (cv2's tie rules)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < TILE; r += WARPS) {
    const int c = lane;
    const int* mp = &s.mag[r + 1][c + 1];
    const int v = *mp, m = v & 0xffff, sector = v >> 16;
    const int d = sector == 0 ? 1 : (sector == 1 ? MT : (sector == 2 ? MT - 1 : MT + 1));
    const int m1 = mp[-d] & 0xffff, m2 = mp[d] & 0xffff;
    const bool keep = m > m1 && (sector >= 2 ? m > m2 : m >= m2);
    uint8_t cls = 0;
    if (keep && m > lo && tl.y0 + r < a.H && tl.x0 + c < a.W) cls = m > hi ? STRONG : WEAK;
    s.cl[r * TILE + c] = cls;
  }
  __syncthreads();
}

// The 3 V values of V pixels side by side (V = 8 in bf16, 4 in fp32: three
// 16-byte vectors), group g of tile row r: value(e) for e in [0, 3 V), the
// values' index in the row segment from the group's first.  Single values
// where the group is cut by the image's edge or its first value is off a
// 16-byte boundary (a width that is no multiple of V).
template <typename T, typename F>
__device__ __forceinline__ void store_group(Raw<T>* dst, const Args& a, const Tile& tl, int r,
                                            int g, F value) {
  constexpr int V = 16 / sizeof(Raw<T>);
  const int y = tl.y0 + r, x = tl.x0 + V * g;
  if (y >= a.H || x >= a.W) return;
  const long long e0 = row0(a, tl.b, y) + 3 * x;
  if (x + V <= a.W && (e0 & (V - 1)) == 0) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      union {
        uint4 u;
        Raw<T> v[V];
      } w;
#pragma unroll
      for (int k = 0; k < V; ++k) w.v[k] = value(q * V + k);
      *reinterpret_cast<uint4*>(dst + e0 + q * V) = w.u;
    }
  } else {
    for (int e = 0; e < 3 * min(V, a.W - x); ++e) dst[e0 + e] = value(e);
  }
}

// Every group of a tile, one a thread.
template <typename T, typename F>
__device__ __forceinline__ void store_tile(Raw<T>* dst, const Args& a, const Tile& tl, F value) {
  constexpr int V = 16 / sizeof(Raw<T>), GROUPS = TILE / V;
  for (int i = threadIdx.x; i < TILE * GROUPS; i += THREADS) {
    const int r = i / GROUPS, g = i % GROUPS;
    store_group<T>(dst, a, tl, r, g, [&](int e) { return value(r, V * 3 * g + e); });
  }
}

// The VAE input of one tile, from its staged rows through the table.
template <typename T>
__device__ void store_vae(const Args& a, const Tile& tl, const uint8_t* stage, const Smem<T>& s) {
  store_tile<T>(static_cast<Raw<T>*>(a.vae_in), a, tl, [&](int r, int e) {
    return s.table[stage[(r + HALO) * ROW_BYTES + s.rbase[r + HALO] + 3 * tl.x0 + e]];
  });
}

// ----------------------------------------------------------- union-find
//
// A node id is a pixel's slot (strong) or the slot plus n (weak); slot(id)
// takes it back.  lab[slot] holds the node's parent id, the root itself.
// Every link points to a smaller id of the same set.

__device__ __forceinline__ int slot_of(int id, int n) { return id >= n ? id - n : id; }

// The labels of a tile in shared memory (n = TPX; volatile: the links other
// threads make are seen), or of the batch in device memory (n = N; through
// L2, where the atomics land).
struct SharedLabels {
  unsigned base;  // the shared-memory address of lab[0]
  static constexpr int n = TPX;
  __device__ explicit SharedLabels(int* lab)
      : base(static_cast<unsigned>(__cvta_generic_to_shared(lab))) {}
  __device__ int load(int slot) const {
    int v;
    asm volatile("ld.volatile.shared.s32 %0, [%1];\n" : "=r"(v) : "r"(base + 4 * slot) : "memory");
    return v;
  }
  __device__ void store(int slot, int v) const {
    asm volatile("st.volatile.shared.s32 [%0], %1;\n" ::"r"(base + 4 * slot), "r"(v) : "memory");
  }
  __device__ int link(int slot, int v) const {  // atomicMin, the old value
    int old;
    asm volatile("atom.shared.min.s32 %0, [%1], %2;\n"
                 : "=r"(old)
                 : "r"(base + 4 * slot), "r"(v)
                 : "memory");
    return old;
  }
};
struct GlobalLabels {
  int* lab;
  int n;
  __device__ int load(int slot) const { return __ldcg(lab + slot); }
  __device__ void store(int slot, int v) const { __stcg(lab + slot, v); }
  __device__ int link(int slot, int v) const { return atomicMin(lab + slot, v); }
};

// The root of `id`, each visited node pointed at its grandparent (path
// halving).  Safe while other threads unite: a grandparent is a smaller id of
// the same set, so the links still lead to the root, and the chains stay
// short however many tiles a component crosses.
template <typename L>
__device__ int find(const L& l, int id) {
  while (true) {
    const int p = l.load(slot_of(id, l.n));
    if (p == id) return id;
    const int gp = l.load(slot_of(p, l.n));
    if (gp == p) return p;
    l.store(slot_of(id, l.n), gp);
    id = gp;
  }
}

// find for a and b side by side: each step's loads of the two in flight
// together, so a union waits for the longer path, not for both.
template <typename L>
__device__ void find2(const L& l, int& a, int& b) {
  bool da = false, db = false;
  while (!(da && db)) {
    const int pa = da ? a : l.load(slot_of(a, l.n)), pb = db ? b : l.load(slot_of(b, l.n));
    da = pa == a;
    db = pb == b;
    const int ga = da ? a : l.load(slot_of(pa, l.n)), gb = db ? b : l.load(slot_of(pb, l.n));
    if (!da) {
      if (ga != pa) l.store(slot_of(a, l.n), ga);
      da = ga == pa;
      a = ga;
    }
    if (!db) {
      if (gb != pb) l.store(slot_of(b, l.n), gb);
      db = gb == pb;
      b = gb;
    }
  }
}

// The sets of a and b made one: the larger root linked to the smaller by
// atomicMin; where another thread linked it first, again from what it found.
template <typename L>
__device__ void unite(const L& l, int a, int b) {
  while (true) {
    find2(l, a, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = l.link(slot_of(b, l.n), a);
    if (old == b) return;
    b = old;
  }
}

// The labels in device memory: a tile-local root holds its node's global id
// (and, once linked, its parent's), another candidate -2 - its local root's
// tile-local node id, a pixel that is no candidate NONE.  Only roots are ever
// on a find's path, so only they are linked.
__device__ __forceinline__ int global_id(int node, int pix0, int W, int n) {
  const int rs = slot_of(node, TPX);
  return pix0 + (rs >> 5) * W + (rs & 31) + (node >= TPX ? n : 0);
}

// A label read as a node id: the local root's global id where it names one
// (pix0: the first pixel of the tile that holds the pixel), as it is else.
__device__ __forceinline__ int root_id(int label, int pix0, int W, int n) {
  return label < NONE ? global_id(-2 - label, pix0, W, n) : label;
}

// The tile-local union-find on s.cl, then each pixel's label.  A row of the
// tile is a warp: each run of candidates in it is linked to its least node
// (its leftmost strong pixel, or its first where none is strong) from two
// ballots, with no atomics; then each pair of runs in neighbouring rows that
// touch is united once: by the lower run's first pixel where the upper run
// holds its NW or N neighbour, else by the pixel whose NE neighbour starts
// the upper run in the window.  A warp takes the pairs whose lower row lies
// in its band of four rows.
template <typename T>
__device__ void local_unions(const Args& a, const Tile& tl, Smem<T>& s, int n) {
  constexpr int BAND = TILE / WARPS;
  const SharedLabels l(s.lab);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < TILE; r += WARPS) {
    const uint8_t v = s.cl[r * TILE + lane];
    const unsigned cand = __ballot_sync(0xffffffffu, v != 0);
    const unsigned strong = __ballot_sync(0xffffffffu, v == STRONG);
    if (v) {
      const unsigned starts = cand & ~(cand << 1), ends = cand & ~(cand >> 1);
      const int first = 31 - __clz(starts & (0xffffffffu >> (31 - lane)));
      const int last = __ffs(ends & (0xffffffffu << lane)) - 1;
      const unsigned st = strong & (0xffffffffu >> (31 - last)) & (0xffffffffu << first);
      s.lab[r * TILE + lane] = (st ? 0 : TPX) + r * TILE + (st ? __ffs(st) - 1 : first);
    }
  }
  __syncthreads();
  // The unions of rows r - 1 and r for the warp's band of rows r: its lanes'
  // pending unions as bits (3 per row: with the NW, N or NE neighbour), then
  // taken side by side, each lane its u-th in round u, so a warp waits for
  // its busiest lane, not for every row in turn.
  unsigned rows[BAND + 1], todo = 0;
#pragma unroll
  for (int q = 0; q <= BAND; ++q) {
    const int r = warp * BAND - 1 + q;
    rows[q] = __ballot_sync(0xffffffffu, r >= 0 && s.cl[r * TILE + lane] != 0);
  }
#pragma unroll
  for (int q = 1; q <= BAND; ++q) {
    const unsigned cand = rows[q], up = rows[q - 1];
    if (!(cand >> lane & 1)) continue;
    const bool first = lane == 0 || !(cand >> (lane - 1) & 1);
    const bool nw = lane > 0 && (up >> (lane - 1) & 1), n_ = up >> lane & 1;
    const bool ne = lane < TILE - 1 && (up >> (lane + 1) & 1) && !n_;
    todo |= ((first && nw) | (first && n_ && !nw) << 1 | ne << 2) << (3 * (q - 1));
  }
  const int rounds = __reduce_max_sync(0xffffffffu, __popc(todo));
  for (int u = 0; u < rounds; ++u) {
    if (!todo) continue;
    const int bit = __ffs(todo) - 1, q = bit / 3, c = lane - 1 + bit % 3;
    todo &= todo - 1;
    const int i = (warp * BAND + q) * TILE + lane, j = i - TILE - lane + c;
    unite(l, s.cl[i] == STRONG ? i : i + TPX, s.cl[j] == STRONG ? j : j + TPX);
  }
  __syncthreads();
  for (int r = warp; r < TILE; r += WARPS) {
    const int i = r * TILE + lane;
    if (tl.y0 + r >= a.H || tl.x0 + lane >= a.W) continue;
    int label = NONE;
    if (s.cl[i]) {
      const int me = s.cl[i] == STRONG ? i : i + TPX, root = find(l, me);
      label = root == me ? global_id(me, tl.pix0, a.W, n) : -2 - root;
    }
    a.labels[tl.pix0 + r * a.W + lane] = label;
  }
}

// ---------------------------------------------------------------- phase 2

// One warp, one edge of a tile: side 0 its top row, 1 its left column, 2 its
// right column (rows 1-31 of the columns: row 0 is the top row's).
__device__ void border_unions(const Args& a, const Tile& tl, int side, int n) {
  const int lane = threadIdx.x & 31;
  const int r = side == 0 ? 0 : lane, c = side == 0 ? lane : (side == 1 ? 0 : TILE - 1);
  const int y = tl.y0 + r, x = tl.x0 + c;
  const int image = tl.b * a.H * a.W;
  int own = NONE, nb[4] = {NONE, NONE, NONE, NONE};
  if ((side == 0 || lane > 0) && y < a.H && x < a.W)
    own = root_id(__ldcg(a.labels + tl.pix0 + r * a.W + c), tl.pix0, a.W, n);
  if (own != NONE) {
    auto look = [&](int k, int dy, int dx) {
      const int ny = y + dy, nx = x + dx;
      if (ny >= 0 && nx >= 0 && nx < a.W) {
        const int pix0 = image + (ny & ~(TILE - 1)) * a.W + (nx & ~(TILE - 1));
        nb[k] = root_id(__ldcg(a.labels + image + ny * a.W + nx), pix0, a.W, n);
      }
    };
    if (side == 0) {
      look(0, -1, -1);
      look(1, -1, 0);
      look(2, -1, 1);
      if (c == 0) look(3, 0, -1);
    } else if (side == 1) {
      look(0, 0, -1);
      look(1, -1, -1);
    } else {
      look(0, -1, 1);
    }
  }
  // a neighbour label the pixel has already met
#pragma unroll
  for (int k = 1; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < k; ++j)
      if (nb[k] == nb[j]) nb[k] = NONE;
  // a neighbour label the pixel before it along the edge has met too: the
  // two are candidates side by side in one tile, so one local component, and
  // that pixel makes the pair (or skipped it, as one the pixel before it made)
  int pnb[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) pnb[k] = __shfl_up_sync(0xffffffffu, nb[k], 1);
  if (lane > 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (nb[k] == pnb[j]) nb[k] = NONE;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (nb[k] != NONE) unite(GlobalLabels{a.labels, n}, own, nb[k]);
}

// Every block arrives; none goes on before all have.  The counter counts
// arrivals over the launch: the first barrier waits for `grid`, the second
// for 2 grid.
__device__ void grid_barrier(unsigned int* counter, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    const unsigned long long t0 = global_ns();
    while (load_acquire(counter) < target) {
      __nanosleep(20);
      if (global_ns() - t0 > SPIN_LIMIT_NS) __trap();
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------- phase 3

// Phase 3 takes a block's tiles two a round (t and t + grid), each thread's
// four labels of each read side by side.
constexpr int PER = TPX / THREADS;

// Two tiles' edges into edges[0..2 TPX): each local root finds its root, the
// other candidates take their local root's from shared memory; then each
// tile's control stored.  One find a local component, not one a pixel: the
// pixels of a large component would all read its root's label in L2 at once.
template <typename T>
__device__ void write_control(const Args& a, int t, uint8_t* edges, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int label[2 * PER];
#pragma unroll
  for (int q = 0; q < 2 * PER; ++q) {
    const int tt = t + q / PER * gridDim.x, r = warp + WARPS * (q % PER);
    const Tile tl = tile_of(a, tt);
    label[q] = tt < a.ntiles && tl.y0 + r < a.H && tl.x0 + lane < a.W
                   ? __ldcg(a.labels + tl.pix0 + r * a.W + lane)
                   : NONE;
  }
#pragma unroll
  for (int q = 0; q < 2 * PER; ++q)
    edges[q / PER * TPX + (warp + WARPS * (q % PER)) * TILE + lane] =
        label[q] >= 0 && find(GlobalLabels{a.labels, n}, label[q]) < n;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 2 * PER; ++q)
    if (label[q] < NONE)
      edges[q / PER * TPX + (warp + WARPS * (q % PER)) * TILE + lane] =
          edges[q / PER * TPX + slot_of(-2 - label[q], TPX)];
  __syncthreads();
  const Raw<T> one = raw_of<T>(1.0f), zero = raw_of<T>(0.0f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int tt = t + h * gridDim.x;
    if (tt >= a.ntiles) break;
    const uint8_t* e = edges + h * TPX;
    store_tile<T>(static_cast<Raw<T>*>(a.control), a, tile_of(a, tt),
                  [&](int r, int v) { return e[r * TILE + v / 3] ? one : zero; });
  }
  __syncthreads();
}

// ------------------------------------------------------------------ kernel

// Each entry's first phase stages the RGB image (with its halo) or the class
// map.
template <int MODE>
__device__ __forceinline__ void stage(const Args& a, int t, uint8_t* dst) {
  if (MODE == HYSTERESIS)
    stage_rows<1, 0>(a, a.cls_in, t, dst);
  else
    stage_rows<3, HALO>(a, a.img, t, dst);
}

// Phase 1 hands out tiles: each block's first is its own index, the rest come
// from a counter, so a block that met light tiles takes more.
__device__ __forceinline__ int next_tile(const Args& a) {
  return gridDim.x + atomicAdd(a.counter + 2, 1u);
}

// The last block out sets the counters back to 0 for the next launch (or
// graph replay): every block has then passed every barrier and taken its
// last tile.
__device__ __forceinline__ void leave(const Args& a) {
  if (threadIdx.x == 0 && atomicAdd(a.counter + 1, 1u) == gridDim.x - 1) {
    a.counter[0] = 0u;
    a.counter[1] = 0u;
    a.counter[2] = 0u;
  }
}

// At least MIN_BLOCKS blocks an SM (at most 48 registers a thread): without the
// floor ptxas gives one instance 32 registers and spills.
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) canny_kernel(const Args a) {
  __shared__ Smem<T> s;
  const int n = a.B * a.H * a.W;
  // stamp: start
  if (threadIdx.x == 0) {
    s.tile[0] = blockIdx.x;
    s.tile[1] = next_tile(a);
  }
  int lo = 0, hi = 0;
  if (MODE != HYSTERESIS) {
    for (int v = threadIdx.x; v < 256; v += THREADS)
      s.table[v] = raw_of<T>(__fsub_rn(__fdiv_rn((float)v, 127.5f), 1.0f));
    lo = *a.low;
    hi = *a.high;
  }
  stage<MODE>(a, blockIdx.x, s.ring[0]);
  cp_async_commit();
  __syncthreads();
  for (int k = 0;; ++k) {
    const int t = s.tile[k & 1], next = s.tile[(k + 1) & 1];
    if (t >= a.ntiles) break;
    const Tile tl = tile_of(a, t);
    if (next < a.ntiles) stage<MODE>(a, next, s.ring[(k + 1) & 1]);
    cp_async_commit();
    if (threadIdx.x < GT)
      s.rbase[threadIdx.x] = MODE == HYSTERESIS ? row_lead<1, 0>(a, tl, threadIdx.x)
                                                : row_lead<3, HALO>(a, tl, threadIdx.x);
    cp_async_wait<1>();
    __syncthreads();  // every thread holds t and next; the stage has landed
    if (threadIdx.x == 0 && next < a.ntiles) s.tile[k & 1] = next_tile(a);
    if (MODE != HYSTERESIS) {
      classes(a, tl, s.ring[k & 1], s, lo, hi);
      if (MODE == FRONT) {
        const int lane = threadIdx.x & 31;
        for (int r = threadIdx.x >> 5; r < TILE; r += WARPS)
          if (tl.y0 + r < a.H && tl.x0 + lane < a.W)
            a.cls_out[tl.pix0 + r * a.W + lane] = s.cl[r * TILE + lane];
      }
      store_vae(a, tl, s.ring[k & 1], s);
    } else {
      const int lane = threadIdx.x & 31;
      const uint8_t* rows = s.ring[k & 1];
      for (int r = threadIdx.x >> 5; r < TILE; r += WARPS)
        s.cl[r * TILE + lane] = tl.y0 + r < a.H && tl.x0 + lane < a.W
                                    ? rows[r * ROW_BYTES + s.rbase[r] + tl.x0 + lane]
                                    : 0;
      __syncthreads();
    }
    if (MODE != FRONT) local_unions(a, tl, s, n);
    __syncthreads();  // the stage and the tile's arrays are free for the next tile
  }
  // stamp: front done
  if (MODE == FRONT) {
    leave(a);
    return;
  }

  grid_barrier(a.counter, gridDim.x);
  // stamp: first barrier passed
  const int warp = threadIdx.x >> 5;
  const int mine = (a.ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;  // this block's tiles
  for (int j = warp; j < 3 * mine; j += WARPS) {
    const int q = j / 3;
    border_unions(a, tile_of(a, blockIdx.x + q * gridDim.x), j - 3 * q, n);
  }
  // stamp: border unions done
  grid_barrier(a.counter, 2 * gridDim.x);
  // stamp: second barrier passed
  // two tiles' edges in s.lab, free now
  for (int t = blockIdx.x; t < a.ntiles; t += 2 * gridDim.x)
    write_control<T>(a, t, reinterpret_cast<uint8_t*>(s.lab), n);
  leave(a);
  // stamp: end
}

// Blocks of canny_kernel<T, MODE> an SM holds at once; 0 where the query fails.
template <typename T, int MODE>
int per_sm() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, canny_kernel<T, MODE>, THREADS, 0) !=
      cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return blocks;
}

// PREPARE and HYSTERESIS meet at grid-wide barriers: a cooperative launch,
// every block resident at once (or refused: cudaErrorCooperativeLaunchTooLarge).
template <typename T, int MODE>
int launch(const Args& a, int grid, void* stream) {
  if (grid < 1 || grid > a.ntiles || a.B < 1 || a.H < 1 || a.W < 1 ||
      ((reinterpret_cast<uintptr_t>(a.img) | reinterpret_cast<uintptr_t>(a.cls_in)) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  if (MODE != FRONT) {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, canny_kernel<T, MODE>, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

Args args(const void* img, const void* cls_in, const void* low, const void* high, void* cls_out,
          void* vae_in, void* control, void* labels, void* counter, int B, int H, int W) {
  Args a;
  a.img = static_cast<const uint8_t*>(img);
  a.cls_in = static_cast<const uint8_t*>(cls_in);
  a.low = static_cast<const int*>(low);
  a.high = static_cast<const int*>(high);
  a.cls_out = static_cast<uint8_t*>(cls_out);
  a.vae_in = vae_in;
  a.control = control;
  a.labels = static_cast<int*>(labels);
  a.counter = static_cast<unsigned int*>(counter);
  a.B = B;
  a.H = H;
  a.W = W;
  a.tiles_x = (W + TILE - 1) / TILE;
  a.tiles_y = (H + TILE - 1) / TILE;
  a.ntiles = B * a.tiles_x * a.tiles_y;
  return a;
}

}  // namespace

// Blocks the card holds at once for every entry (the least of them: SMs x
// blocks per SM), into *out: what ops/canny.plan sizes the grid to.
extern "C" int canny_slots(int* out) {
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n[6] = {per_sm<__nv_bfloat16, PREPARE>(), per_sm<__nv_bfloat16, FRONT>(),
                    per_sm<__nv_bfloat16, HYSTERESIS>(), per_sm<float, PREPARE>(),
                    per_sm<float, FRONT>(), per_sm<float, HYSTERESIS>()};
  int least = n[0];
  for (int v : n) least = min(least, v);
  *out = least * sms;
  return least > 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The shared memory of a block: item size 2 (bf16 outputs) or 4 (fp32).
extern "C" int canny_smem_bytes(int itemsize) {
  return itemsize == 4 ? (int)sizeof(Smem<float>) : (int)sizeof(Smem<__nv_bfloat16>);
}

// img uint8 [B, H, W, 3], 16-byte aligned; low and high: int32 thresholds on
// the device, low <= high; labels int32 [B, H, W] scratch (no initial value
// needed); counter: 3 uint32, zero before the call and after it; control and
// vae_in [B, H, W, 3] out.  `grid`: ops/canny.plan's.
extern "C" int canny_prepare_bf16(const void* img, const void* low, const void* high,
                                  void* labels, void* counter, void* control, void* vae_in,
                                  int B, int H, int W, int grid, void* stream) {
  return launch<__nv_bfloat16, PREPARE>(
      args(img, nullptr, low, high, nullptr, vae_in, control, labels, counter, B, H, W), grid,
      stream);
}
extern "C" int canny_prepare_f32(const void* img, const void* low, const void* high, void* labels,
                                 void* counter, void* control, void* vae_in, int B, int H, int W,
                                 int grid, void* stream) {
  return launch<float, PREPARE>(
      args(img, nullptr, low, high, nullptr, vae_in, control, labels, counter, B, H, W), grid,
      stream);
}

// The front alone: cls uint8 [B, H, W] out (0, 1 weak, 2 strong) and vae_in;
// counter as for prepare.
extern "C" int canny_front_bf16(const void* img, const void* low, const void* high, void* counter,
                                void* cls, void* vae_in, int B, int H, int W, int grid,
                                void* stream) {
  return launch<__nv_bfloat16, FRONT>(
      args(img, nullptr, low, high, cls, vae_in, nullptr, nullptr, counter, B, H, W), grid,
      stream);
}
extern "C" int canny_front_f32(const void* img, const void* low, const void* high, void* counter,
                               void* cls, void* vae_in, int B, int H, int W, int grid,
                               void* stream) {
  return launch<float, FRONT>(
      args(img, nullptr, low, high, cls, vae_in, nullptr, nullptr, counter, B, H, W), grid,
      stream);
}

// The hysteresis alone: control [B, H, W, 3] in {0, 1} from cls uint8 [B, H, W].
extern "C" int canny_hysteresis_bf16(const void* cls, void* labels, void* counter, void* control,
                                     int B, int H, int W, int grid, void* stream) {
  return launch<__nv_bfloat16, HYSTERESIS>(
      args(nullptr, cls, nullptr, nullptr, nullptr, nullptr, control, labels, counter, B, H, W),
      grid, stream);
}
extern "C" int canny_hysteresis_f32(const void* cls, void* labels, void* counter, void* control,
                                    int B, int H, int W, int grid, void* stream) {
  return launch<float, HYSTERESIS>(
      args(nullptr, cls, nullptr, nullptr, nullptr, nullptr, control, labels, counter, B, H, W),
      grid, stream);
}
