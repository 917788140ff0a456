"""A spec for ``tools/kernel_variants.py``: Canny prepare's kernels with
``%globaltimer`` stamps at their phases and with parts taken out, at 1024²,
batch 1 and 4, on chip_smoke's test images at (100, 200) and on random
candidate maps at densities 0.1 and 0.6.

    python fastedit_tpu_torch/tools/kernel_variants.py \
        fastedit_tpu_torch/tools/variants_canny.py

It reads whichever ``csrc/canny.cu`` the tree of ``kernel_variants.py`` holds:
run that tree's script (``python build/parent/fastedit_tpu_torch/tools/
kernel_variants.py fastedit_tpu_torch/tools/variants_canny.py`` reads a
``git archive`` of another tree).  Two designs are known:

* three kernels and four launches (``canny_front_kernel``, ``ccl_local``,
  ``ccl_border``, ``ccl_write``): the stamps give each front block's start,
  gray, magnitude, NMS and VAE-input ends, and every ``ccl_*`` block's start
  and end; ``no_vae`` drops the VAE-input loop; the hysteresis is also timed
  with each of its launches left out (time only);
* one persistent kernel (``canny_kernel``, three entries): the stamps give
  each block's start, its tiles' front ends, the two grid barriers and its
  end, and the µs of each step of its last tile's first phase (gray,
  magnitude, NMS, VAE input, local unions: min / median / max over
  blocks); ``no_vae`` drops the VAE-input stores, ``no_border`` the border
  unions (time only), ``no_ring`` waits for each tile's copy before the
  next is issued, ``no_run_unions`` leaves each run of a row its own
  component (time only), ``min_blocks_6`` and ``min_blocks_8`` hold the
  kernel to more blocks an SM (fewer registers); ``two_launches_pdl`` is
  prepare as two launches, the second cooperative and chained by
  programmatic dependent launch in place of the first grid-wide barrier.

Every time is the mean device µs of a CUDA graph of 20 calls
(``tools/timing.graph_ms``); the stamps are µs from the grid's first start:
min / median / max over the blocks.
"""

from fastedit_tpu_torch.ops import build as _build

LIBRARY = "canny"
_SOURCE = _build.CSRC / "canny.cu"  # the tree's whose kernel_variants.py runs this spec

_TIMER = ('__device__ __forceinline__ unsigned long long gtime() {\n'
          '  unsigned long long v;\n  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));\n'
          '  return v;\n}\n')
_READ = ('extern "C" int canny_read_stamps(void* host, int which) {\n'
         '  return (int)cudaMemcpyFromSymbol(host, which == 0 ? (const void*)&st_front\n'
         '                                  : (const void*)&st_ccl, sizeof(st_front));\n}\n')
NSTAMP, NBLOCK = 6, 16384  # stamps per block, blocks kept per kernel

# ------------------------------------------- three kernels and four launches

_OLD_STAMPS = [
    ("namespace {\n\nconstexpr int TILE = 32;",
     "namespace {\n\n" + _TIMER
     + f"__device__ unsigned long long st_front[{NSTAMP}][{NBLOCK}];\n"
     + f"__device__ unsigned long long st_ccl[{NSTAMP}][{NBLOCK}];\n"
     "__device__ __forceinline__ int blk() {\n"
     "  return (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;\n}\n"
     "__device__ __forceinline__ void mark(unsigned long long (*a)[16384], int i) {\n"
     "  if (threadIdx.x == 0 && blk() < 16384) a[i][blk()] = gtime();\n}\n\n"
     "constexpr int TILE = 32;"),
    ("  const int tid = threadIdx.x;\n\n  // gray at the tile",
     "  const int tid = threadIdx.x;\n  mark(st_front, 0);\n\n  // gray at the tile"),
    ("  __syncthreads();\n\n  // gx, gy at gray[r][c]",
     "  __syncthreads();\n  mark(st_front, 1);\n\n  // gx, gy at gray[r][c]"),
    ("  __syncthreads();\n\n  const int lo = *low_threshold",
     "  __syncthreads();\n  mark(st_front, 2);\n\n  const int lo = *low_threshold"),
    ("  // the VAE input: each row",
     "  __syncthreads();\n  mark(st_front, 3);\n  // the VAE input: each row"),
    ("    vae_in[off] = from_float<T>(__fsub_rn(__fdiv_rn((float)img[off], 127.5f), 1.0f));\n"
     "  }\n}",
     "    vae_in[off] = from_float<T>(__fsub_rn(__fdiv_rn((float)img[off], 127.5f), 1.0f));\n"
     "  }\n  __syncthreads();\n  mark(st_front, 4);\n}"),
    # ccl_local: stamps 0 and 1; ccl_border 2 and 3; ccl_write 4 and 5
    ("  __shared__ uint8_t cl[TPX];\n  const int b = blockIdx.z, y0 = blockIdx.y * TILE, "
     "x0 = blockIdx.x * TILE;\n  const size_t image = (size_t)b * H * W;\n"
     "  const int tid = threadIdx.x;\n",
     "  __shared__ uint8_t cl[TPX];\n  const int b = blockIdx.z, y0 = blockIdx.y * TILE, "
     "x0 = blockIdx.x * TILE;\n  const size_t image = (size_t)b * H * W;\n"
     "  const int tid = threadIdx.x;\n  mark(st_ccl, 0);\n"),
    ("    labels[image + (size_t)(y0 + i / TILE) * W + x0 + i % TILE] = root < TPX ? g : g + n;\n"
     "  }\n}",
     "    labels[image + (size_t)(y0 + i / TILE) * W + x0 + i % TILE] = root < TPX ? g : g + n;\n"
     "  }\n  __syncthreads();\n  mark(st_ccl, 1);\n}"),
    # the border kernel's body as a function, so its early returns all end in one stamp
    ("__global__ void __launch_bounds__(BORDER_THREADS)\n    ccl_border_kernel(",
     "__device__ void ccl_border_body(const uint8_t* __restrict__ cls, int* __restrict__ labels,\n"
     "                                int H, int W, int n);\n"
     "__global__ void __launch_bounds__(BORDER_THREADS)\n"
     "    ccl_border_kernel(const uint8_t* __restrict__ cls, int* __restrict__ labels, int H,\n"
     "                      int W, int n) {\n"
     "  mark(st_ccl, 2);\n  ccl_border_body(cls, labels, H, W, n);\n  __syncthreads();\n"
     "  mark(st_ccl, 3);\n}\n__device__ void ccl_border_body("),
    ("  const int i = blockIdx.x * WRITE_THREADS + threadIdx.x;\n  if (i >= n) return;",
     "  const int i = blockIdx.x * WRITE_THREADS + threadIdx.x;\n  mark(st_ccl, 4);\n"
     "  if (i >= n) return;"),
    ("  control[3 * (size_t)i + 2] = o;\n}",
     "  control[3 * (size_t)i + 2] = o;\n  __syncthreads();\n  mark(st_ccl, 5);\n}"),
    ("}  // namespace\n", "}  // namespace\n\n" + _READ),
]
_OLD = {
    "as_built": [],
    "stamps": _OLD_STAMPS,
    "no_vae": [("  for (int i = tid; i < TILE * TILE * 3; i += THREADS) {",
                "  for (int i = tid; i < 0; i += THREADS) {")],
}

# --------------------------------------------------- one persistent kernel

_NEW_STAMPS = [
    ("namespace {\n\nconstexpr int TILE = 32;",
     "namespace {\n\n" + _TIMER
     + f"__device__ unsigned long long st_front[{NSTAMP}][{NBLOCK}];\n"
     + f"__device__ unsigned long long st_ccl[{NSTAMP}][{NBLOCK}];\n"
     "__device__ __forceinline__ void mark(int i) {\n"
     "  if (threadIdx.x == 0 && blockIdx.x < 16384) st_front[i][blockIdx.x] = gtime();\n}\n"
     "__device__ __forceinline__ void step(int i) {\n"
     "  if (threadIdx.x == 0 && blockIdx.x < 16384) st_ccl[i][blockIdx.x] = gtime();\n}\n\n"
     "constexpr int TILE = 32;"),
    # phase 1's steps, each block's last tile: copy landed (or class map read),
    # gray, magnitude, NMS, VAE input, local unions
    ("    __syncthreads();  // every thread holds t and next; the stage has landed\n",
     "    __syncthreads();  // every thread holds t and next; the stage has landed\n"
     "    step(0);\n"),
    ("  __syncthreads();\n\n  // L1 magnitude", "  __syncthreads();\n  step(1);\n\n  // L1 magnitude"),
    ("  __syncthreads();\n\n  // NMS along", "  __syncthreads();\n  step(2);\n\n  // NMS along"),
    ("    s.cl[r * TILE + c] = cls;\n  }\n  __syncthreads();\n",
     "    s.cl[r * TILE + c] = cls;\n  }\n  __syncthreads();\n  step(3);\n"),
    ("      store_vae(a, tl, s.ring[k & 1], s);\n",
     "      store_vae(a, tl, s.ring[k & 1], s);\n      __syncthreads();\n      step(4);\n"),
    ("                                    : 0;\n      __syncthreads();\n",
     "                                    : 0;\n      __syncthreads();\n      step(0);\n"),
    ("    if (MODE != FRONT) local_unions(a, tl, s, n);\n    __syncthreads();",
     "    if (MODE != FRONT) local_unions(a, tl, s, n);\n    __syncthreads();\n    step(5);"),
    ("  // stamp: start\n", "  mark(0);\n"),
    ("  // stamp: front done\n", "  mark(1);\n"),
    ("  // stamp: first barrier passed\n", "  mark(2);\n"),
    ("  // stamp: border unions done\n", "  mark(3);\n"),
    ("  // stamp: second barrier passed\n", "  mark(4);\n"),
    ("  // stamp: end\n", "  mark(5);\n"),
    ("}  // namespace\n", "}  // namespace\n\n" + _READ),
]
# Prepare as two launches: the first (phase 1) plain, the second (the edge
# unions, one barrier, the write) cooperative and chained by programmatic
# dependent launch, which waits for the first grid's memory at its start
# instead of a grid-wide barrier.
_PDL_LAUNCH = """
template <typename T>
int launch_two(Args a, int grid, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = static_cast<cudaStream_t>(stream);
  a.part = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, canny_kernel<T, PREPARE>, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  a.part = 2;
  e = cudaLaunchKernelEx(&cfg, canny_kernel<T, PREPARE>, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace
"""
_PDL = [
    ("  int ntiles;             // of the batch\n",
     "  int ntiles;             // of the batch\n  int part;  // 0 all, 1 phase 1, 2 the rest\n"),
    ("  a.ntiles = B * a.tiles_x * a.tiles_y;\n",
     "  a.ntiles = B * a.tiles_x * a.tiles_y;\n  a.part = 0;\n"),
    # the second launch takes no tile in phase 1 (its first tile is out of
    # range, its stage and counter untouched); the first leaves the counters
    # to the second's last block
    ("    s.tile[0] = blockIdx.x;\n    s.tile[1] = next_tile(a);\n",
     "    s.tile[0] = a.part == 2 ? a.ntiles : blockIdx.x;\n"
     "    s.tile[1] = a.part == 2 ? a.ntiles : next_tile(a);\n"),
    ("  stage<MODE>(a, blockIdx.x, s.ring[0]);\n",
     "  if (a.part != 2) stage<MODE>(a, blockIdx.x, s.ring[0]);\n"),
    ("  if (MODE == FRONT) {\n    leave(a);\n    return;\n  }\n",
     "  if (MODE == FRONT) {\n    leave(a);\n    return;\n  }\n  if (a.part == 1) {\n"
     "    asm volatile(\"griddepcontrol.launch_dependents;\" ::: \"memory\");\n    return;\n  }\n"
     "  if (a.part == 2) asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");\n"),
    ("  grid_barrier(a.counter, gridDim.x);\n", "  if (a.part != 2) grid_barrier(a.counter, gridDim.x);\n"),
    ("  grid_barrier(a.counter, 2 * gridDim.x);\n",
     "  grid_barrier(a.counter, (a.part == 2 ? 1 : 2) * gridDim.x);\n"),
    ("}  // namespace\n", _PDL_LAUNCH),
    ("  return launch<__nv_bfloat16, PREPARE>(\n", "  return launch_two<__nv_bfloat16>(\n"),
    ("  return launch<float, PREPARE>(\n", "  return launch_two<float>(\n"),
]
_NEW = {
    "as_built": [],
    "two_launches_pdl": _PDL,
    "stamps": _NEW_STAMPS,
    "no_vae": [("      store_vae(a, tl, s.ring[k & 1], s);\n", "")],
    "no_border": [("    border_unions(a, tile_of", "    if (false) border_unions(a, tile_of")],
    "no_ring": [("    cp_async_wait<1>();", "    cp_async_wait<0>();")],
    # time only: each run its own component (the labels stay valid node ids)
    "no_run_unions": [("  const int rounds = __reduce_max_sync(0xffffffffu, __popc(todo));",
                       "  const int rounds = 0;")],
    # more blocks an SM, fewer registers a thread
    "min_blocks_6": [("constexpr int MIN_BLOCKS = 5;", "constexpr int MIN_BLOCKS = 6;")],
    "min_blocks_8": [("constexpr int MIN_BLOCKS = 5;", "constexpr int MIN_BLOCKS = 8;")],
}

VARIANTS = _OLD if "ccl_border_kernel" in _SOURCE.read_text() else _NEW
SIZE = 1024
THRESHOLDS = (100, 200)


def _inputs(torch, np):
    """(name, uint8 images [B, 1024, 1024, 3] or None, class map [B, 1024,
    1024] or None) at batch 1 and 4."""
    import chip_smoke
    from fastedit_tpu_torch.tools.conformance import stress_classes

    masks = dict(stress_classes(seed=1, size=SIZE))
    out = []
    for b in (1, 4):
        img = np.stack([np.asarray(chip_smoke.test_image(70 + i)) for i in range(b)])
        out.append((f"photo b{b}", torch.from_numpy(img).cuda(), None))
        for name in ("random 0.1", "random 0.6"):
            cls = torch.from_numpy(np.stack([masks[name]] * b)).cuda()
            out.append((f"{name} b{b}", None, cls))
    return out


def _spread(stamps, n, names, base):
    """min / median / max over the first ``n`` blocks of each stamp, µs from
    ``base``."""
    import numpy as np

    out = []
    for i, name in enumerate(names):
        v = (np.asarray(stamps[i][:n], dtype=np.float64) - base) / 1e3
        out.append(f"{name} {v.min():.2f}/{np.median(v):.2f}/{v.max():.2f}")
    return "  ".join(out)


def _read(lib, which):
    import ctypes

    import numpy as np

    buf = (ctypes.c_ulonglong * (NSTAMP * NBLOCK))()
    err = lib.canny_read_stamps(ctypes.byref(buf), which)
    if err:
        raise RuntimeError(f"canny_read_stamps: CUDA error {err}")
    return np.frombuffer(buf, dtype=np.uint64).reshape(NSTAMP, NBLOCK).astype(np.int64)


def _old_runs(canny, torch, img, cls, dtype):
    """The calls timed on the three-kernel design: its wrappers, and the
    hysteresis with each launch left out."""
    b, h, w = cls.shape
    labels = torch.empty((b, h, w), dtype=torch.int32, device="cuda")
    control = torch.empty((b, h, w, 3), dtype=dtype, device="cuda")
    sfx = "f32" if dtype == torch.float32 else "bf16"

    def launch(*names):
        def fn():
            for name in names:
                if name == "write":
                    canny._launch(f"ccl_write_{sfx}", cls.device, cls.data_ptr(),
                                  labels.data_ptr(), control.data_ptr(), b, h, w)
                else:
                    canny._launch(f"ccl_{name}", cls.device, cls.data_ptr(), labels.data_ptr(),
                                  b, h, w)
        return fn

    runs = {"hysteresis": launch("local", "border", "write"),
            "hyst without local": launch("border", "write"),
            "hyst without border": launch("local", "write"),
            "hyst without write": launch("local", "border")}
    if img is not None:
        lo, hi = canny.threshold_tensors(*THRESHOLDS, "cuda")
        runs = {"prepare": lambda: canny.prepare(img, lo, hi, dtype),
                "front": lambda: canny.canny_front(img, lo, hi, dtype), **runs}
    launch("local", "border", "write")()  # labels in a merged state for "without local"
    return runs


def _new_runs(canny, torch, img, cls, dtype):
    runs = {"hysteresis": lambda: canny.canny_hysteresis(cls, dtype)}
    if img is not None:
        lo, hi = canny.threshold_tensors(*THRESHOLDS, "cuda")
        runs = {"prepare": lambda: canny.prepare(img, lo, hi, dtype),
                "front": lambda: canny.canny_front(img, lo, hi, dtype), **runs}
    return runs


def run(use):
    import numpy as np
    import torch

    from fastedit_tpu_torch.ops import canny
    from fastedit_tpu_torch.tools.timing import graph_ms

    old = VARIANTS is _OLD
    print("design:", "three kernels, four launches" if old else "one persistent kernel",
          flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        for name, img, cls in _inputs(torch, np):
            if img is not None:
                lo, hi = canny.threshold_tensors(*THRESHOLDS, "cuda")
                use("as_built")
                cls, _ = canny.canny_front(img, lo, hi, dtype)
            want = canny.canny_hysteresis_plain(cls, dtype)
            for variant in use.names:
                use(variant)
                runs = (_old_runs if old else _new_runs)(canny, torch, img, cls, dtype)
                try:
                    got = canny.canny_hysteresis(cls, dtype)
                    if "prepare" in runs:
                        runs["prepare"]()
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    print(f"{str(dtype)[6:]:8s} {name:14s} {variant:10s} failed: {e}", flush=True)
                    continue
                same = bool(torch.equal(got, want))
                if "prepare" in runs:
                    same &= bool(torch.equal(runs["prepare"]()[0], want))
                times = "  ".join(f"{k} {1e3 * graph_ms(fn):.2f}" for k, fn in runs.items())
                print(f"{str(dtype)[6:]:8s} {name:14s} {variant:10s} control equal {same!s:5s} "
                      f"us: {times}", flush=True)
            if "stamps" not in use.names:
                continue
            lib = use("stamps")
            first = runs["prepare" if img is not None else "hysteresis"]
            first()
            torch.cuda.synchronize()
            if old:
                b, h, w = cls.shape
                nfront = b * (h // 32) * (w // 32)
                if img is not None:
                    front = _read(lib, 0)
                    base = front[0][:nfront].min()
                    print("   front:", _spread(front, nfront, ("start", "gray", "mag", "nms",
                                                            "vae"), base), flush=True)
                else:
                    runs["hysteresis"]()
                    torch.cuda.synchronize()
                ccl = _read(lib, 1)
                if img is None:
                    base = ccl[0][:nfront].min()
                nwrite = -(-b * h * w // 256)
                print("   ccl:  ", _spread(ccl[0:2], nfront, ("local start", "local end"), base),
                      _spread(ccl[2:4], nfront, ("border start", "border end"), base),
                      _spread(ccl[4:6], min(nwrite, NBLOCK), ("write start", "write end"),
                              base), flush=True)
            else:
                grid = canny.plan_for(cls).grid
                st = _read(lib, 0)
                base = st[0][:grid].min()
                print("   blocks:", _spread(st, grid, ("start", "front", "barrier 1", "border",
                                                       "barrier 2", "end"), base), flush=True)
                steps = _read(lib, 1)[:, :grid].astype(np.float64)  # the last tile's steps
                names = ("gray", "magnitude", "NMS", "VAE input", "local unions")
                for i, what in enumerate(names, 1):
                    # a step's µs: from the step before it that ran (an entry skips some)
                    prev = next(j for j in range(i - 1, -1, -1) if steps[j].max() > base)
                    if steps[i].max() > base:
                        d = (steps[i] - steps[prev]) / 1e3
                        print(f"   step {what:12s} {d.min():.2f}/{np.median(d):.2f}/{d.max():.2f}",
                              flush=True)
