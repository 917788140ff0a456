// Canny prepare on the card: the edge map of ControlNet-Canny and the VAE
// input, in four kernels and a fixed number of launches, with no host
// synchronisation, so a CUDA graph captures the whole of prepare.
//
// Serves the JAX package's prepare (fastedit_tpu/pipeline/stages.py
// `_prepare_one_fn`), which computes Canny in XLA, not in Pallas
// (fastedit_tpu/ops/canny.py `canny_jax`: the stencil part at :42-99, the
// hysteresis, a lax.while_loop of masked dilations to a fixed point, at
// :102-137).  Bit-exact to `canny_np` (and so to cv2 5.0): the shift-15 gray,
// Sobel with a replicate border and the L1 magnitude, cv2's integer NMS
// sectors (TG22 = 13573) and tie rules, the thresholds compared strictly, and
// 8-connected hysteresis.
//
//   canny_front_kernel<T>  one stencil pass per 32 x 32 tile: the gray of the
//                          tile and a two-pixel halo (replicate border) in
//                          shared memory, the magnitude of the tile and a
//                          one-pixel ring (0 outside the image, NMS's zero
//                          border), then per pixel NMS and the double
//                          threshold, written as a class map (0 none, 1 weak:
//                          a candidate, 2 strong); in the same pass the VAE
//                          input f / 127.5 - 1 in T (fp32 division and
//                          subtraction with round-to-nearest, then one
//                          rounding to bf16), rows of the tile read and
//                          written contiguously.  The thresholds are read from
//                          device memory (two int32, floored and ordered on
//                          the host: ops/canny.threshold_tensors), so one
//                          graph serves every threshold.
//   canny_hysteresis       the set of candidates 8-connected to a strong pixel
//                          through candidates, as connected-component
//                          labelling by union-find (the fixed point of the
//                          masked dilation, whatever the length of a chain):
//     ccl_local_kernel       per 32 x 32 tile in shared memory: each candidate
//                            unites with its candidate W, NW, N and NE
//                            neighbours inside the tile (atomicMin links), then
//                            points at its tile-local root, written as a
//                            global node id;
//     ccl_border_kernel      one thread per pixel of a tile's top row, left and
//                            right column: unites with its backward neighbours
//                            (W, NW, N, NE) that lie in another tile, on the
//                            global labels (atomicMin, reads through L2);
//     ccl_write_kernel<T>    per pixel: a candidate finds its root (halving the
//                            path as it goes: no union runs any more, so a
//                            shortcut is always to an ancestor) and writes
//                            control = 1 if the root is strong, else 0, three
//                            channels in T.
//
// The node ids make the strong test free: a strong pixel p is node p, a weak
// one node N + p (N pixels in the batch), both kept in slot p of the labels
// (int32 [N]; each pixel has one node).  Every link points to a smaller id, so
// a component's root is its least id, which is strong exactly when the
// component holds a strong pixel.  Atomics order the links by scheduling, so
// the labels differ from run to run; the roots' classes, and so the output,
// do not.
//
// What bounds it on an H100: bytes.  Per 1024² image the front reads 3 MB of
// uint8 RGB and writes the 1 MB class map and the VAE input (6 MB in bf16,
// 12 in fp32); the hysteresis reads the class map and writes control (6 or
// 12 MB), and its labels (4 MB) stay mostly in the 50 MB L2.  A union's find
// walks a chain of links whose length grows with how many tiles a component
// crosses: a stress image whose one component winds through every tile walks
// the longest ones.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE = 32;              // a block's tile side, pixels
constexpr int TPX = TILE * TILE;      // pixels of a tile
constexpr int THREADS = 256;          // front and local kernels
constexpr int HALO = 2;               // Sobel's ring plus NMS's ring
constexpr int GT = TILE + 2 * HALO;   // gray tile side
constexpr int MT = TILE + 2;          // magnitude tile side
constexpr int BORDER_PX = 3 * TILE - 2;  // top row, left and right columns
constexpr int BORDER_THREADS = 96;
constexpr int WRITE_THREADS = 256;

constexpr int GRAY_R = 9798, GRAY_G = 19235, GRAY_B = 3735, GRAY_SHIFT = 15;
constexpr int CANNY_SHIFT = 15, TG22 = 13573;
constexpr uint8_t WEAK = 1, STRONG = 2;

// The backward half of the 8-neighbourhood, (dy, dx): every 8-connected pair
// of pixels is one pixel's backward neighbour of the other.
__constant__ int BACK_DY[4] = {0, -1, -1, -1};
__constant__ int BACK_DX[4] = {-1, -1, 0, 1};

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// ---------------------------------------------------------------- front

template <typename T>
__global__ void __launch_bounds__(THREADS)
    canny_front_kernel(const uint8_t* __restrict__ img, const int* __restrict__ low_threshold,
                       const int* __restrict__ high_threshold, uint8_t* __restrict__ cls,
                       T* __restrict__ vae_in, int H, int W) {
  __shared__ int gray[GT][GT];
  __shared__ int mag[MT][MT];
  const int b = blockIdx.z, y0 = blockIdx.y * TILE, x0 = blockIdx.x * TILE;
  const size_t image = (size_t)b * H * W;
  const uint8_t* im = img + image * 3;
  const int tid = threadIdx.x;

  // gray at the tile and its two-pixel halo, the border replicated
  for (int i = tid; i < GT * GT; i += THREADS) {
    const int r = i / GT, c = i % GT;
    const int y = clampi(y0 - HALO + r, 0, H - 1), x = clampi(x0 - HALO + c, 0, W - 1);
    const uint8_t* p = im + ((size_t)y * W + x) * 3;
    gray[r][c] = (p[0] * GRAY_R + p[1] * GRAY_G + p[2] * GRAY_B + (1 << (GRAY_SHIFT - 1))) >>
                 GRAY_SHIFT;
  }
  __syncthreads();

  // gx, gy at gray[r][c]: sh(dy, dx) = gray[r + dy][c + dx]
  auto sobel = [&](int r, int c, int& gx, int& gy) {
    gx = (gray[r - 1][c + 1] - gray[r - 1][c - 1]) + 2 * (gray[r][c + 1] - gray[r][c - 1]) +
         (gray[r + 1][c + 1] - gray[r + 1][c - 1]);
    gy = (gray[r + 1][c - 1] - gray[r - 1][c - 1]) + 2 * (gray[r + 1][c] - gray[r - 1][c]) +
         (gray[r + 1][c + 1] - gray[r - 1][c + 1]);
  };

  // L1 magnitude at the tile and a one-pixel ring, 0 outside the image
  for (int i = tid; i < MT * MT; i += THREADS) {
    const int r = i / MT, c = i % MT;
    const int y = y0 - 1 + r, x = x0 - 1 + c;
    int m = 0;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      int gx, gy;
      sobel(r + 1, c + 1, gx, gy);
      m = abs(gx) + abs(gy);
    }
    mag[r][c] = m;
  }
  __syncthreads();

  const int lo = *low_threshold, hi = *high_threshold;  // floored, lo <= hi (the host's)
  for (int i = tid; i < TPX; i += THREADS) {
    const int r = i / TILE, c = i % TILE, y = y0 + r, x = x0 + c;
    if (y >= H || x >= W) continue;
    int gx, gy;
    sobel(r + HALO, c + HALO, gx, gy);
    const int mr = r + 1, mc = c + 1, m = mag[mr][mc];
    const int ax = abs(gx), ay = abs(gy) << CANNY_SHIFT;
    const int tg22x = ax * TG22;
    const int tg67x = tg22x + ((2 * ax) << CANNY_SHIFT);
    bool keep;
    if (ay < tg22x) {
      keep = m > mag[mr][mc - 1] && m >= mag[mr][mc + 1];
    } else if (ay > tg67x) {
      keep = m > mag[mr - 1][mc] && m >= mag[mr + 1][mc];
    } else if ((gx ^ gy) < 0) {
      keep = m > mag[mr - 1][mc + 1] && m > mag[mr + 1][mc - 1];
    } else {
      keep = m > mag[mr - 1][mc - 1] && m > mag[mr + 1][mc + 1];
    }
    const bool cand = keep && m > lo;
    cls[image + (size_t)y * W + x] = cand ? (m > hi ? STRONG : WEAK) : 0;
  }

  // the VAE input: each row of the tile is min(TILE, W - x0) x 3 contiguous values
  const int row_vals = min(TILE, W - x0) * 3;
  for (int i = tid; i < TILE * TILE * 3; i += THREADS) {
    const int r = i / (TILE * 3), e = i % (TILE * 3), y = y0 + r;
    if (y >= H || e >= row_vals) continue;
    const size_t off = (image + (size_t)y * W + x0) * 3 + e;
    vae_in[off] = from_float<T>(__fsub_rn(__fdiv_rn((float)img[off], 127.5f), 1.0f));
  }
}

// ----------------------------------------------------------- union-find
//
// A node id is a pixel's slot (strong) or the slot plus n (weak); slot(id)
// takes it back.  lab[slot] holds the node's parent id, the root itself.

__device__ __forceinline__ int slot_of(int id, int n) { return id >= n ? id - n : id; }

// In shared memory: n = TPX, tile-local slots; volatile reads see the links
// other threads make.
__device__ int find_local(volatile int* lab, int id) {
  int p = lab[slot_of(id, TPX)];
  while (p != id) {
    id = p;
    p = lab[slot_of(id, TPX)];
  }
  return id;
}

__device__ void unite_local(int* lab, int a, int b) {
  bool done;
  do {
    a = find_local(lab, a);
    b = find_local(lab, b);
    if (a < b) {
      const int old = atomicMin(lab + slot_of(b, TPX), a);
      done = old == b;
      b = old;
    } else if (b < a) {
      const int old = atomicMin(lab + slot_of(a, TPX), b);
      done = old == a;
      a = old;
    } else {
      done = true;
    }
  } while (!done);
}

// In device memory: n = N, reads through L2 (__ldcg), where the atomics land.
__device__ int find_global(const int* labels, int n, int id) {
  int p = __ldcg(labels + slot_of(id, n));
  while (p != id) {
    id = p;
    p = __ldcg(labels + slot_of(id, n));
  }
  return id;
}

__device__ void unite_global(int* labels, int n, int a, int b) {
  bool done;
  do {
    a = find_global(labels, n, a);
    b = find_global(labels, n, b);
    if (a < b) {
      const int old = atomicMin(labels + slot_of(b, n), a);
      done = old == b;
      b = old;
    } else if (b < a) {
      const int old = atomicMin(labels + slot_of(a, n), b);
      done = old == a;
      a = old;
    } else {
      done = true;
    }
  } while (!done);
}

__global__ void __launch_bounds__(THREADS)
    ccl_local_kernel(const uint8_t* __restrict__ cls, int* __restrict__ labels, int H, int W,
                     int n) {
  __shared__ int lab[TPX];
  __shared__ uint8_t cl[TPX];
  const int b = blockIdx.z, y0 = blockIdx.y * TILE, x0 = blockIdx.x * TILE;
  const size_t image = (size_t)b * H * W;
  const int tid = threadIdx.x;
  for (int i = tid; i < TPX; i += THREADS) {
    const int y = y0 + i / TILE, x = x0 + i % TILE;
    const uint8_t v = (y < H && x < W) ? cls[image + (size_t)y * W + x] : 0;
    cl[i] = v;
    lab[i] = v == STRONG ? i : i + TPX;
  }
  __syncthreads();
  for (int i = tid; i < TPX; i += THREADS) {
    if (!cl[i]) continue;
    const int r = i / TILE, c = i % TILE;
    const int me = cl[i] == STRONG ? i : i + TPX;
    for (int k = 0; k < 4; ++k) {
      const int nr = r + BACK_DY[k], nc = c + BACK_DX[k];
      if (nr < 0 || nc < 0 || nc >= TILE) continue;
      const int j = nr * TILE + nc;
      if (cl[j]) unite_local(lab, me, cl[j] == STRONG ? j : j + TPX);
    }
  }
  __syncthreads();
  for (int i = tid; i < TPX; i += THREADS) {
    if (!cl[i]) continue;
    const int root = find_local(lab, cl[i] == STRONG ? i : i + TPX);
    const int rs = slot_of(root, TPX);
    const int g = (int)(image + (size_t)(y0 + rs / TILE) * W + x0 + rs % TILE);
    labels[image + (size_t)(y0 + i / TILE) * W + x0 + i % TILE] = root < TPX ? g : g + n;
  }
}

__global__ void __launch_bounds__(BORDER_THREADS)
    ccl_border_kernel(const uint8_t* __restrict__ cls, int* __restrict__ labels, int H, int W,
                      int n) {
  const int t = threadIdx.x;
  if (t >= BORDER_PX) return;
  // t < TILE: the top row; then the left column below it; then the right one
  const int r = t < TILE ? 0 : (t < 2 * TILE - 1 ? t - TILE + 1 : t - 2 * TILE + 2);
  const int c = t < TILE ? t : (t < 2 * TILE - 1 ? 0 : TILE - 1);
  const int b = blockIdx.z, y = blockIdx.y * TILE + r, x = blockIdx.x * TILE + c;
  if (y >= H || x >= W) return;
  const size_t image = (size_t)b * H * W;
  const size_t p = image + (size_t)y * W + x;
  if (!cls[p]) return;
  for (int k = 0; k < 4; ++k) {
    const int nr = r + BACK_DY[k], nc = c + BACK_DX[k];
    if (nr >= 0 && nc >= 0 && nc < TILE) continue;  // inside the tile: the local kernel's
    const int ny = y + BACK_DY[k], nx = x + BACK_DX[k];
    if (ny < 0 || nx < 0 || nx >= W) continue;
    const size_t q = image + (size_t)ny * W + nx;
    if (cls[q]) unite_global(labels, n, __ldcg(labels + p), __ldcg(labels + q));
  }
}

// The root of `id`, each visited node pointed at its grandparent (path
// halving).  Only once every union is done: a shortcut then always leads to an
// ancestor, whatever another thread wrote first.
__device__ int find_halving(int* labels, int n, int id) {
  while (true) {
    const int p = __ldcg(labels + slot_of(id, n));
    if (p == id) return id;
    const int gp = __ldcg(labels + slot_of(p, n));
    if (gp == p) return p;
    __stcg(labels + slot_of(id, n), gp);
    id = gp;
  }
}

template <typename T>
__global__ void __launch_bounds__(WRITE_THREADS)
    ccl_write_kernel(const uint8_t* __restrict__ cls, int* __restrict__ labels,
                     T* __restrict__ control, int n) {
  const int i = blockIdx.x * WRITE_THREADS + threadIdx.x;
  if (i >= n) return;
  float v = 0.0f;
  if (cls[i]) v = find_halving(labels, n, __ldcg(labels + i)) < n ? 1.0f : 0.0f;
  const T o = from_float<T>(v);
  control[3 * (size_t)i] = o;
  control[3 * (size_t)i + 1] = o;
  control[3 * (size_t)i + 2] = o;
}

dim3 tiles(int B, int H, int W) { return dim3((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B); }

template <typename T>
int front(const void* img, const void* low, const void* high, void* cls, void* vae_in, int B,
          int H, int W, void* stream) {
  canny_front_kernel<T><<<tiles(B, H, W), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (const int*)low, (const int*)high, (uint8_t*)cls, (T*)vae_in, H, W);
  return (int)cudaGetLastError();
}

template <typename T>
int write(const void* cls, void* labels, void* control, int B, int H, int W, void* stream) {
  const int n = B * H * W;
  ccl_write_kernel<T><<<(n + WRITE_THREADS - 1) / WRITE_THREADS, WRITE_THREADS, 0,
                        (cudaStream_t)stream>>>((const uint8_t*)cls, (int*)labels, (T*)control,
                                                n);
  return (int)cudaGetLastError();
}

}  // namespace

// img uint8 [B, H, W, 3]; low and high: int32 thresholds on the device, low <=
// high; cls uint8 [B, H, W] out (0, 1 weak, 2 strong); vae_in [B, H, W, 3] out.
extern "C" int canny_front_bf16(const void* img, const void* low, const void* high, void* cls,
                                void* vae_in, int B, int H, int W, void* stream) {
  return front<__nv_bfloat16>(img, low, high, cls, vae_in, B, H, W, stream);
}
extern "C" int canny_front_f32(const void* img, const void* low, const void* high, void* cls,
                               void* vae_in, int B, int H, int W, void* stream) {
  return front<float>(img, low, high, cls, vae_in, B, H, W, stream);
}

// The hysteresis' first two launches: labels int32 [B, H, W] (scratch, no
// initial value needed) from cls uint8 [B, H, W].
extern "C" int ccl_local(const void* cls, void* labels, int B, int H, int W, void* stream) {
  ccl_local_kernel<<<tiles(B, H, W), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)cls, (int*)labels, H, W, B * H * W);
  return (int)cudaGetLastError();
}
extern "C" int ccl_border(const void* cls, void* labels, int B, int H, int W, void* stream) {
  ccl_border_kernel<<<tiles(B, H, W), BORDER_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)cls, (int*)labels, H, W, B * H * W);
  return (int)cudaGetLastError();
}
// The last launch: control [B, H, W, 3] in {0, 1}.
extern "C" int ccl_write_bf16(const void* cls, void* labels, void* control, int B, int H, int W,
                              void* stream) {
  return write<__nv_bfloat16>(cls, labels, control, B, H, W, stream);
}
extern "C" int ccl_write_f32(const void* cls, void* labels, void* control, int B, int H, int W,
                             void* stream) {
  return write<float>(cls, labels, control, B, H, W, stream);
}
