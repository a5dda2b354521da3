// Device and host helpers shared by the hand-written Hopper (sm_90a) kernels:
// mbarriers, TMA tile loads, wgmma matrix descriptors and instructions, and
// the host-side tensor-map encoder. cuTensorMapEncodeTiled is a driver
// function; it is looked up through the runtime (cudaGetDriverEntryPoint),
// so the library links no libcuda.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ---------------------------------------------------------------
//
// Phase convention: a consumer's n-th wait on a "full" barrier passes parity
// n & 1; a producer's n-th wait on an "empty" barrier passes parity
// (n & 1) ^ 1, so its first wait passes before any consumer has arrived.

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// The producer's arrival, announcing the bytes its TMA loads will deliver.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA tile loads: a box of a tensor map into shared memory ----------------
// Coordinates are signed element indices, innermost first; elements outside
// the tensor are written as zeros and still count toward the barrier's bytes.

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// ---- wgmma -------------------------------------------------------------------

constexpr uint32_t LAYOUT_INTERLEAVE = 0;  // no swizzle: 8 rows x 16 bytes per core matrix
constexpr uint32_t LAYOUT_B128 = 1;        // TMA's 128-byte swizzle

// Shared-memory matrix descriptor. For a K-major operand, `lbo` is the byte
// stride between the two 8-element K chunks of a k16 step (no swizzle) and
// `sbo` the stride between 8-row groups; for an MN-major operand, `lbo` is
// the stride between 8-row K groups (no swizzle) and `sbo` between 8-element
// MN groups; with the 128-byte swizzle, `sbo` is the stride between 8-row
// groups of 128-byte rows (1024).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma instructions (zero fill before, epilogue after).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64 x N, fp32, registers) += A(64 x 16) . B(16 x N), both of element
// type T (bf16 or f16: the same instruction shapes, fragment layouts and
// transpose bits) in shared memory. TA / TB: 0 = K-major, 1 = MN-major.
// Accumulator layout: thread t of the warpgroup holds rows (t / 32) * 16 +
// (t % 32) / 4 + {0, 8}, columns 8 j + 2 (t % 4) + {0, 1}, as d[4 j + {0, 1}]
// (row +0) and d[4 j + {2, 3}].
#define PCMSEG_WGMMA_D32 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define PCMSEG_WGMMA_D64 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define PCMSEG_WGMMA_N64(TYPE)                                                                  \
  asm volatile(                                                                                \
      "{\n"                                                                                     \
      ".reg .pred p;\n"                                                                         \
      "setp.ne.b32 p, %34, 0;\n"                                                                \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE " "                           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "  \
      "%32, %33, p, 1, 1, %35, %36;\n"                                                          \
      "}\n"                                                                                     \
      : PCMSEG_WGMMA_D32                                                                       \
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TA), "n"(TB))
#define PCMSEG_WGMMA_N128(TYPE)                                                                 \
  asm volatile(                                                                                \
      "{\n"                                                                                     \
      ".reg .pred p;\n"                                                                         \
      "setp.ne.b32 p, %66, 0;\n"                                                                \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE " "                          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "  \
      "%64, %65, p, 1, 1, %67, %68;\n"                                                          \
      "}\n"                                                                                     \
      : PCMSEG_WGMMA_D64                                                                       \
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TA), "n"(TB))

template <int TA, int TB, typename T = bf16>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  static_assert(std::is_same<T, bf16>::value || std::is_same<T, f16>::value, "bf16 or f16 operands");
  if constexpr (std::is_same<T, f16>::value)
    PCMSEG_WGMMA_N64("f16");
  else
    PCMSEG_WGMMA_N64("bf16");
}

template <int TA, int TB, typename T = bf16>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  static_assert(std::is_same<T, bf16>::value || std::is_same<T, f16>::value, "bf16 or f16 operands");
  if constexpr (std::is_same<T, f16>::value)
    PCMSEG_WGMMA_N128("f16");
  else
    PCMSEG_WGMMA_N128("bf16");
}

#undef PCMSEG_WGMMA_N64
#undef PCMSEG_WGMMA_N128
#undef PCMSEG_WGMMA_D32
#undef PCMSEG_WGMMA_D64

// ---- TF32 wgmma with A from registers (3xTF32 fp32 products) ----------------
//
// D(64 x N, fp32, registers) (+)= A(64 x 8, tf32, registers) . B(8 x N, tf32,
// K-major in shared memory). TF32 wgmma takes K-major operands only (the
// transpose bits exist for f16 / bf16). A fragment: thread t of the
// warpgroup holds rows r = (t / 32) * 16 + (t % 32) / 4 and r + 8, columns
// c = t % 4 and c + 4, as a[0] (r, c), a[1] (r + 8, c), a[2] (r, c + 4),
// a[3] (r + 8, c + 4) (the layout of mma.m16n8k8's tf32 A, one per warp).
// D's layout is the bf16 instructions' above. scale_d 0: D = A.B (a fresh
// accumulator), 1: D += A.B. A K-major no-swizzle B core matrix is 8 rows
// x 16 bytes (4 tf32 values): `lbo` is the stride between the two 4-value
// K halves of a k8 step, `sbo` the stride between 8-row groups; with the
// 128-byte swizzle a k8 step is 32 bytes of a 128-byte row, sbo 1024.

__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// cvt.rna.tf32.f32: a rounded to 10 mantissa bits, to nearest with ties away
// from zero, the low 13 bits zero.
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

// a = hi + lo + O(2^-22 |a|): hi = tf32(a), lo = tf32(a - hi) (a - hi is
// exact in fp32). hi.hi + hi.lo + lo.hi is a's product to fp32 accuracy.
__device__ __forceinline__ void tf32_split(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// Make the generic proxy's shared-memory writes visible to the async proxy
// (wgmma's operand reads, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Give a warpgroup's registers back to the pool (a producer) or take more
// (consumers): every thread of the warpgroup runs it; N a multiple of 8.
template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Named barrier `id` (1..15) over `count` threads (a multiple of 32).
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- host ------------------------------------------------------------------

int sm_count(int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return 132;
  return sms;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Make `device` current for a launch; returns the error of the switch.
cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor-map data type of element type T (bf16, f16 or fp32).
template <typename T>
constexpr CUtensorMapDataType tensor_map_type() {
  if constexpr (std::is_same<T, float>::value) return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  else if constexpr (std::is_same<T, f16>::value) return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  else return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

inline size_t tensor_map_element_bytes(CUtensorMapDataType type) {
  return type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
}

// Tensor map of a tensor of `type` (bf16, f16 or fp32): `rank` dims,
// dims[0] innermost and contiguous, byte strides of dims 1..rank-1, `box`
// elements per dim loaded at a time, optionally 128-byte swizzled.
cudaError_t make_tensor_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                            const cuuint64_t* strides, const cuuint32_t* box, bool swizzle128,
                            CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, type, rank, const_cast<void*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 5-D map of an NDHWC tensor of `type` (dims C, W, H, D, N) loading boxes
// of {bc channels, bx, by, bz, 1}: the 16-bit kernels use bc = 8 (16-byte
// rows, no swizzle) and bc = 64 with `swizzle128` (128-byte rows,
// swizzled), the fp32 ones unswizzled rows of 4, 8 and 64 channels.
cudaError_t make_ndhwc_map(CUtensorMap* map, const void* base, int N, int D, int H, int W, int C, int bc,
                           int bx, int by, int bz, bool swizzle128,
                           CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t row = static_cast<cuuint64_t>(C) * tensor_map_element_bytes(type);
  const cuuint64_t strides[4] = {row, row * W, row * W * H, row * W * H * D};
  const cuuint32_t box[5] = {static_cast<cuuint32_t>(bc), static_cast<cuuint32_t>(bx),
                             static_cast<cuuint32_t>(by), static_cast<cuuint32_t>(bz), 1};
  return make_tensor_map(map, base, 5, dims, strides, box, swizzle128, type);
}

}  // namespace
