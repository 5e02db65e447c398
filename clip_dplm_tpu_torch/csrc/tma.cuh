// Tiles in shared memory for wgmma, and the Tensor Memory Accelerator (TMA)
// copies that fill them: the 128-byte swizzle, mbarrier completion, the
// device-side box copies and the host-side tensor maps. Shared by the flash
// kernels (flash_attention.cu), the short-S forward (short_attention.cu), the
// GEMM (dense_gemm.cuh) and the CLS backward (cls_attention.cu).
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "common.cuh"

namespace clip_dplm {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Element offset of (row r, column d) in a rows x Dp bf16 tile: Dp/64 blocks
// of rows x 64 side by side, and inside a block row r's 16-byte chunk c at
// chunk c ^ (r % 8): the 128-byte swizzle of TMA's SW128 boxes and wgmma's
// SW128 operands (wgmma.cuh). Every block starts on a 1024-byte boundary
// when the tile does and rows is a multiple of 8.
__device__ __forceinline__ int swz(int rows, int r, int d) {
  return (d >> 6) * (rows * 64) + r * 64 + ((((d >> 3) & 7) ^ (r & 7)) << 3) + (d & 7);
}
template <int Rows>
__device__ __forceinline__ int swz(int r, int d) {
  return swz(Rows, r, d);
}

// A barrier whose phase completes after `arrivals` arrivals (and the bytes
// announced with them).
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned arrivals = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(arrivals)
               : "memory");
}
// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// The one arrival of a phase, with the bytes its copies will bring.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// One arrival without bytes (a consumer releasing a ring slot).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Rows [row0, row0 + Rows) of slice `slice` of a (slices, rows, Dh) tensor,
// by TMA into a swizzled Rows x Dp tile: one 64-column box per block that
// holds a column below Dh (the blocks past Dh are never read); columns past
// Dh and rows past the tensor's end arrive as zeros.
template <int Rows>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map, int row0, int slice,
                                         int Dh, uint64_t* bar) {
  const int blocks = (Dh + 63) / 64;
  for (int blk = 0; blk < blocks; ++blk)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst + blk * Rows * 64)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(blk * 64), "r"(row0), "r"(slice),
        "r"(smem_u32(bar))
        : "memory");
}

// One box of a 1-D tensor map at coordinate c0 into dst; completes on bar.
__device__ __forceinline__ void tma_box_1d(void* dst, const CUtensorMap* map, int c0,
                                           uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2}], [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(smem_u32(bar))
      : "memory");
}

// One box of a 2-D tensor map at coordinates (c0, c1), innermost first, into
// dst; completes on bar.
__device__ __forceinline__ void tma_box_2d(bf16* dst, const CUtensorMap* map, int c0, int c1,
                                           uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// One box of a 3-D tensor map at coordinates (c0, c1, c2), innermost first,
// into dst; completes on bar.
__device__ __forceinline__ void tma_box_3d(bf16* dst, const CUtensorMap* map, int c0, int c1,
                                           int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// One box of a 4-D tensor map at coordinates (c0, c1, c2, c3), innermost
// first, into dst; completes on bar.
__device__ __forceinline__ void tma_box_4d(bf16* dst, const CUtensorMap* map, int c0, int c1,
                                           int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (no -lcuda).
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor of `rank` dimensions (dims innermost first, the innermost
// contiguous; strides in bytes of dimensions 1 .. rank-1) as TMA boxes of
// `box` elements a dimension, 128-byte swizzled (box[0] = 64) unless another
// swizzle is given (CU_TENSOR_MAP_SWIZZLE_NONE: box rows dense, box[0]·2 a
// multiple of 16 bytes, up to 256 elements); reads past its edges give zeros.
inline bool tensor_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box,
                       CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiledFn encode = encode_tiled();
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  auto run = [&] {
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                  strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  };
  if (encode == nullptr) return false;
  if (run()) return true;
  // cuTensorMapEncodeTiled works on the calling thread's current context,
  // and a thread that has made no runtime call yet has none (an autograd
  // worker whose first node is a kernel's backward): make the device's
  // primary context current there, and encode again.
  int dev;
  return cudaGetDevice(&dev) == cudaSuccess && cudaSetDevice(dev) == cudaSuccess && run();
}

// A (slices, rows, Dh) bf16 tensor as boxes of 64 columns by box_rows rows
// of one slice.
inline bool tensor_map(CUtensorMap* map, const void* base, int Dh, int rows, int slices,
                       int box_rows) {
  const cuuint64_t dims[3] = {cuuint64_t(Dh), cuuint64_t(rows), cuuint64_t(slices)};
  const cuuint64_t strides[2] = {cuuint64_t(Dh) * 2, cuuint64_t(rows) * Dh * 2};  // bytes
  const cuuint32_t box[3] = {64, cuuint32_t(box_rows), 1};
  return tensor_map(map, base, 3, dims, strides, box);
}

}  // namespace clip_dplm
