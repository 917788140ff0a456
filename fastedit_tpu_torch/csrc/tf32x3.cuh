// What the 3xTF32 kernels of this directory share (conv3x3_tf32x3.cu,
// flash_attention_tf32x3.cu): the split of an fp32 value into two TF32
// values, wgmma at .tf32, and fp32 tensor maps.  Built on hopper.cuh.
//
// 3xTF32: an fp32 product a * b on the tensor cores as three TF32 products,
//   a * b ~ a_hi * b_hi + a_hi * b_lo + a_lo * b_hi,
// with x_hi = tf32(x) rounded to nearest (cvt.rna.tf32.f32) and x_lo =
// tf32(x - x_hi), also rounded.  wgmma reads the top 19 bits of an fp32 word
// (sign, exponent, 10 mantissa bits) and drops the rest, so x_hi must be
// rounded, not left to that truncation: a truncated x_hi leaves a lo of up to
// 2^-10 |x| where the rounded one leaves 2^-11 |x|.  A TF32 product is exact
// in fp32, the dropped a_lo * b_lo is below 2^-22 |a b| and each lo carries a
// rounding of 2^-11 of itself, so a product keeps ~2^-21 relative error
// against fp32's 2^-24 per operation; single-pass TF32 (x_hi alone) keeps
// 2^-11.  The rate: 494.7 TFLOP/s dense TF32 (NVIDIA's H100 SXM data sheet),
// ~165 TFLOP/s of fp32 products at three per product, against 67 TFLOP/s of
// fp32 FFMAs outside the tensor cores.
//
// wgmma's transpose bits exist only for 16-bit types: at .tf32 both operands
// are K-major (each row of A or B holds its k values contiguously), which a
// 128-byte swizzle row does for 32 fp32 values; a k step of 8 adds 32 bytes,
// 2 to a descriptor.  A may come from registers: thread t of warp w of the
// warpgroup holds a[0] = A[16w + t/4][t%4], a[1] = A[16w + t/4 + 8][t%4],
// a[2] and a[3] the same at column t%4 + 4.  The accumulator's layout is
// hopper.cuh's: d[4j + 2h + e] = D[16w + t/4 + 8h][8j + 2(t%4) + e].

#pragma once

#include "hopper.cuh"

namespace tf32x3 {

using namespace hopper;

// x rounded to the nearest TF32 value (ties away from zero), as an fp32 word
// whose low 13 bits are zero.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + (|x| 2^-22 at most): both TF32, hi rounded from x and lo
// from the exact remainder x - hi.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// Descriptor of a K-major operand in the 128-byte swizzle (rows of 128
// bytes, 8-row groups 1024 bytes apart): hopper::smem_desc.

// A 3-D load issued by the threads whose `pred` is not 0, without a branch
// (a warpgroup that loads what it consumes between its own wgmmas).
__device__ __forceinline__ void tma_load_3d_if(int pred, uint32_t dst, const CUtensorMap* map,
                                               uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "@p cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n}\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(pred)
      : "memory");
}

// d[64 x N] (+)= a[64 x 8] * b[N x 8]^T at .tf32, b through its descriptor, a
// through its descriptor (ss) or from registers (rs); N = 8, 48, 64 or 80 (4,
// 24, 32 or 40 accumulators); `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[4], const uint32_t (&a)[4],
                                             uint64_t desc_b, int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[24], const uint32_t (&a)[4],
                                             uint64_t desc_b, int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[40], const uint32_t (&a)[4],
                                             uint64_t desc_b, int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// fp32 tensor map, 128-byte swizzle (a box's innermost extent is 32 values,
// 128 bytes), zero fill outside the tensor.  dims and box innermost first;
// strides in bytes for dims 1.. .
inline int encode_map_f32(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                          const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kEncodeFailed;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(base),
                            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

// Raise a kernel's dynamic shared memory limit, once per device.
template <typename Kernel>
inline int allow_smem(Kernel kernel, int bytes, unsigned long long& configured) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!(configured >> (device & 63) & 1)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured |= 1ull << (device & 63);
  }
  return 0;
}

}  // namespace tf32x3
