// The package's bf16 GEMM for Hopper (sm_90a): C = A·B with bf16 operands,
// f32 accumulation and an optional bias epilogue, bf16 out. Used by the fused
// Dense block (csrc/fused_dense.cu: u = x·W^T + b, dx = du·W) and the
// attention out-projection and its dO (csrc/short_attention.cu, tiny path:
// y = o·Wo^T + bo, dO = dy·Wo). It computes the products the TPU kernels
// clip_dplm_tpu/ops/fused_dense.py::_fwd_kernel (x·W) and _bwd_kernel
// (du·W^T), and short_attention.py::_fwd_kernel_qkv (o·Wo + bo) and
// _bwd_kernel_qkv (dy·Wo^T) compute in their own bodies.
//
// Bounds on the H100: at the train step's shapes (M = 8192, N, K in
// 1024..2048) a launch carries 17-69 GFLOP against 20-40 MB, so the tensor
// cores bound it (0.0174 ms at M=8192 N=K=1024 at 989 TFLOP/s); the
// attention's out-projection at N=K=512..640 is bound by its bytes at
// large M. So:
//  * the products are warpgroup wgmma (wgmma.cuh), m64n128k16 with both
//    operands read from shared memory through SW128 descriptors: a block
//    owns a 128 x 128 tile of C, two consumer warpgroups of 64 rows each,
//    the accumulator (64 f32 a thread) in registers for the whole k walk;
//  * A and B arrive by TMA (tma.cuh) from one lane of a producer warp, in
//    64-wide k steps (one SW128 atom of bf16) through a ring of kGemmStages
//    slots of 32 KB: a full mbarrier a slot (its bytes), and an empty one on
//    which the eight consumer warps release it once their products on it
//    have retired, so no consumer waits on another and the copies run
//    stages ahead; rows past M, columns past Nc and k past Kr arrive as
//    zeros (TMA's out-of-bounds fill), so the main loop has no mask;
//  * B comes K-major (W^T of an (N, K) weight: 128 rows of 64 k, one box)
//    or MN-major (B row-major (Kr, Nc): two boxes of 64 k rows x 64 columns,
//    the descriptor's LBO the step between them, the transpose bit set);
//  * the epilogue adds the bias and rounds on the accumulators in
//    registers, stages the bf16 tile through the freed ring (a padded pitch:
//    no bank conflicts) and writes 16-byte rows, masked at the ragged edge;
//  * ~97 KB of shared memory and <= 112 registers a thread keep two blocks
//    on an SM, so one block's prologue and epilogue overlap the other's
//    products.
// Each output is summed in one block in one order (no split-K), so two
// launches are equal byte for byte.
#pragma once

#include <string.h>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace clip_dplm {
namespace {

constexpr int kGemmM = 128, kGemmN = 128, kGemmK = 64;  // block tile; k step
constexpr int kGemmStages = 3;
constexpr int kGemmConsumers = 256;                   // two warpgroups
constexpr int kGemmThreads = kGemmConsumers + kWarp;  // and the producer warp
constexpr unsigned kGemmTileA = kGemmM * kGemmK * sizeof(bf16);  // 16 KB
constexpr unsigned kGemmTileB = kGemmN * kGemmK * sizeof(bf16);  // 16 KB
constexpr int kGemmLdC = kGemmN + 8;                             // the epilogue's staging pitch
constexpr size_t kGemmB = kGemmStages * size_t(kGemmTileA);      // offset of the B ring
constexpr size_t kGemmBar = kGemmB + kGemmStages * size_t(kGemmTileB);
constexpr size_t kGemmSmem = kGemmBar + 2 * kGemmStages * sizeof(uint64_t) + 1024;  // + alignment
static_assert(2 * 64 * kGemmLdC * sizeof(bf16) <= kGemmB, "the staged C tile fits the A ring");

// The 256 consumer threads (named barrier 3; wg_sync takes 1 and 2).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// C (M, Nc) = A (M, Kr) · B (Kr, Nc). A is row-major (tm_a: boxes of 64 k by
// 128 rows). B_ROW: B row-major (Kr, Nc) (tm_b: boxes of 64 columns by 64 k
// rows); else B is given as its transpose, row-major (Nc, Kr) (tm_b: boxes
// of 64 k by 128 rows). With bias: ROUND_BEFORE_BIAS gives
// C = bf16(bf16(acc) + bias) (the fused Dense reference's bias add in bf16),
// else C = bf16(acc + bias) (one rounding, as the attention reference's
// out-projection); no bias: C = bf16(acc).
template <bool B_ROW, bool ROUND_BEFORE_BIAS>
__global__ void __launch_bounds__(kGemmThreads, 2)
dense_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_b, const bf16* __restrict__ bias,
                  bf16* __restrict__ C, int M, int Nc, int Kr) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = reinterpret_cast<bf16*>(smem + kGemmB);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kGemmBar);  // a slot's copies landed
  uint64_t* empty = full + kGemmStages;  // a slot's products retired
  const int m0 = blockIdx.y * kGemmM, n0 = blockIdx.x * kGemmN;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int nk = (Kr + kGemmK - 1) / kGemmK;

  if (tid == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(&full[s]);
      mbar_init(&empty[s], kGemmConsumers / kWarp);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kGemmConsumers / kWarp) {  // the producer warp: one lane issues every copy
    if (lane == 0 && nk > 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_b))
                   : "memory");
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kGemmStages, k0 = kt * kGemmK;
        if (kt >= kGemmStages) mbar_wait(&empty[s], (kt / kGemmStages + 1) & 1);
        mbar_expect_tx(&full[s], kGemmTileA + kGemmTileB);
        tma_box_2d(sA + s * (kGemmM * kGemmK), &tm_a, k0, m0, &full[s]);
        bf16* b = sB + s * (kGemmN * kGemmK);
        if (B_ROW) {
          tma_box_2d(b, &tm_b, n0, k0, &full[s]);
          tma_box_2d(b + 64 * kGemmK, &tm_b, n0 + 64, k0, &full[s]);
        } else {
          tma_box_2d(b, &tm_b, k0, n0, &full[s]);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = warp / 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kGemmStages;
    mbar_wait(&full[s], (kt / kGemmStages) & 1);
    const bf16* a = sA + s * (kGemmM * kGemmK) + wg * (64 * kGemmK);
    const bf16* b = sB + s * (kGemmN * kGemmK);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGemmK / 16; ++kk) {
      // a k16 step: 32 bytes along a K-major row, or 16 rows of 128 bytes of
      // an MN-major block
      const uint64_t desc_b = B_ROW ? gmma_desc(b + kk * 16 * 64, 64 * kGemmK * 2, 1024)
                                    : gmma_desc(b + kk * 16, 16, 1024);
      wgmma_m64n128k16_ss<B_ROW>(acc, gmma_desc(a + kk * 16, 16, 1024), desc_b, true);
    }
    wgmma_commit();
    wgmma_wait<1>();  // step kt-1's products retired: release its slot
    fence_regs(acc);
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kGemmStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: bias and rounding on the accumulators; the bf16 tile through
  // the A ring (both warpgroups are done with it, and every copy has landed),
  // then 16-byte rows of C
  consumers_sync();
  bf16* stage = reinterpret_cast<bf16*>(smem) + wg * (64 * kGemmLdC);
  const int g = lane >> 2, t = lane & 3, r0 = (warp % 4) * 16 + g;
#pragma unroll
  for (int n = 0; n < kGemmN / 8; ++n) {
    const int col = 8 * n + 2 * t;
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr && n0 + 8 * n < Nc) {
      b0 = __bfloat162float(bias[n0 + col]);
      b1 = __bfloat162float(bias[n0 + col + 1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v0 = acc[4 * n + 2 * i], v1 = acc[4 * n + 2 * i + 1];
      if (bias != nullptr) {
        if (ROUND_BEFORE_BIAS) v0 = bf16r(v0), v1 = bf16r(v1);
        v0 += b0;
        v1 += b1;
      }
      *reinterpret_cast<uint32_t*>(stage + (r0 + 8 * i) * kGemmLdC + col) = pack_bf16(v0, v1);
    }
  }
  wg_sync(wg);
  for (int c = tid % 128; c < 64 * (kGemmN / 8); c += 128) {
    const int r = c / (kGemmN / 8), cc = (c % (kGemmN / 8)) * 8;
    const int gm = m0 + wg * 64 + r, gn = n0 + cc;
    if (gm < M && gn < Nc)
      *reinterpret_cast<uint4*>(C + size_t(gm) * Nc + gn) =
          *reinterpret_cast<const uint4*>(stage + r * kGemmLdC + cc);
  }
}

// Launch dense_gemm_kernel<B_ROW, ROUND_BEFORE_BIAS> on `stream`. Kr and Nc
// are multiples of 8 and A, B, C 16-byte aligned (TMA's rules for the
// tensor maps, and C's 16-byte stores); anything else is refused.
template <bool ROUND_BEFORE_BIAS>
cudaError_t launch_dense_gemm(const void* A, const void* B, const void* bias, void* C, int M,
                              int Nc, int Kr, bool b_row, cudaStream_t stream) {
  dim3 grid((Nc + kGemmN - 1) / kGemmN, (M + kGemmM - 1) / kGemmM);
  if (grid.y > 65535 || Kr % 8 || Nc % 8 || (reinterpret_cast<uintptr_t>(C) & 15))
    return cudaErrorInvalidValue;
  CUtensorMap tm_a, tm_b;
  memset(&tm_a, 0, sizeof(tm_a));
  memset(&tm_b, 0, sizeof(tm_b));
  if (Kr > 0 && M > 0 && Nc > 0) {  // else no copy is issued, or the empty grid is refused
    const cuuint64_t a_dims[2] = {cuuint64_t(Kr), cuuint64_t(M)};
    const cuuint64_t a_strides[1] = {cuuint64_t(Kr) * 2};
    const cuuint32_t a_box[2] = {64, kGemmM};
    const cuuint64_t b_dims[2] = {b_row ? cuuint64_t(Nc) : cuuint64_t(Kr),
                                  b_row ? cuuint64_t(Kr) : cuuint64_t(Nc)};
    const cuuint64_t b_strides[1] = {(b_row ? cuuint64_t(Nc) : cuuint64_t(Kr)) * 2};
    const cuuint32_t b_box[2] = {64, b_row ? 64u : cuuint32_t(kGemmN)};
    if (!tensor_map(&tm_a, A, 2, a_dims, a_strides, a_box) ||
        !tensor_map(&tm_b, B, 2, b_dims, b_strides, b_box))
      return cudaErrorInvalidValue;
  }
  auto kernel = b_row ? dense_gemm_kernel<true, ROUND_BEFORE_BIAS>
                      : dense_gemm_kernel<false, ROUND_BEFORE_BIAS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kGemmSmem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kGemmThreads, kGemmSmem, stream>>>(
      tm_a, tm_b, static_cast<const bf16*>(bias), static_cast<bf16*>(C), M, Nc, Kr);
  return cudaGetLastError();
}

}  // namespace
}  // namespace clip_dplm
