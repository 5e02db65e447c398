// The package's bf16 GEMM for Hopper (sm_90a): C = A·B with bf16 operands
// and f32 accumulation in WMMA 16x16x16 tiles (128x128x32 block tile, 8
// warps, a two-stage cp.async ring), with an optional bias epilogue. Used by
// the fused Dense block (csrc/fused_dense.cu: u = x·W^T + b, dx = du·W) and
// the attention out-projection (csrc/short_attention.cu: y = o·Wo^T + bo).
//
// Bounds on the H100: at the train step's shapes (M = 8192, N, K in
// 1024..2048) a launch carries 17-69 GFLOP and is bound by the WMMA tiles'
// shared-memory traffic, well under the tensor cores' peak (wgmma and TMA
// are later work).
#pragma once

#include "common.cuh"

namespace clip_dplm {
namespace {

constexpr int kGemmThreads = 256;
constexpr int kGM = 128, kGN = 128, kGK = 32;
constexpr int kLdA = kGK + 8;        // sA[m][k]
constexpr int kLdBc = kGK + 8;       // sB[n][k] (B column-major)
constexpr int kLdBr = kGN + 8;       // sB[k][n] (B row-major)
constexpr int kLdCg = kGN + 4;       // f32 epilogue tile
constexpr size_t kStageA = size_t(kGM) * kLdA * sizeof(bf16);
constexpr size_t kStageB =
    (size_t(kGN) * kLdBc > size_t(kGK) * kLdBr ? size_t(kGN) * kLdBc : size_t(kGK) * kLdBr) *
    sizeof(bf16);
constexpr size_t kGemmPipe = 2 * (kStageA + kStageB);
constexpr size_t kGemmEpi = size_t(kGM) * kLdCg * sizeof(float);
constexpr size_t kGemmSmem = kGemmPipe > kGemmEpi ? kGemmPipe : kGemmEpi;

// C (M, Nc) = A (M, Kr) · B (Kr, Nc). A is row-major with leading dim Kr.
// B_ROW: B row-major (Kr, Nc); else B is given as its transpose, row-major
// (Nc, Kr). Kr and Nc are multiples of 8 and pointers 16-byte aligned.
// With bias: ROUND_BEFORE_BIAS gives C = bf16(bf16(acc) + bias) (the fused
// Dense reference's bias add in bf16), else C = bf16(acc + bias) (one
// rounding, as the attention reference's out-projection); no bias:
// C = bf16(acc).
template <bool B_ROW, bool ROUND_BEFORE_BIAS>
__global__ void __launch_bounds__(kGemmThreads)
dense_gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                  const bf16* __restrict__ bias, bf16* __restrict__ C, int M, int Nc, int Kr) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA[2] = {reinterpret_cast<bf16*>(smem), reinterpret_cast<bf16*>(smem + kStageA + kStageB)};
  bf16* sB[2] = {reinterpret_cast<bf16*>(smem + kStageA),
                 reinterpret_cast<bf16*>(smem + 2 * kStageA + kStageB)};
  float* sC = reinterpret_cast<float*>(smem);
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int tid = threadIdx.x, warp = tid / kWarp, wm = warp / 4, wn = warp % 4;

  auto load_stage = [&](int st, int k0) {
    for (int c = tid; c < kGM * (kGK / 8); c += kGemmThreads) {
      const int r = c / (kGK / 8), kc = (c % (kGK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + kc < Kr;
      cp_async16(sA[st] + r * kLdA + kc, ok ? A + size_t(m0 + r) * Kr + k0 + kc : A, ok);
    }
    if (B_ROW) {
      for (int c = tid; c < kGK * (kGN / 8); c += kGemmThreads) {
        const int r = c / (kGN / 8), nc = (c % (kGN / 8)) * 8;
        const bool ok = k0 + r < Kr && n0 + nc < Nc;
        cp_async16(sB[st] + r * kLdBr + nc, ok ? B + size_t(k0 + r) * Nc + n0 + nc : B, ok);
      }
    } else {
      for (int c = tid; c < kGN * (kGK / 8); c += kGemmThreads) {
        const int r = c / (kGK / 8), kc = (c % (kGK / 8)) * 8;
        const bool ok = n0 + r < Nc && k0 + kc < Kr;
        cp_async16(sB[st] + r * kLdBc + kc, ok ? B + size_t(n0 + r) * Kr + k0 + kc : B, ok);
      }
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (Kr + kGK - 1) / kGK;
  load_stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_stage((kt + 1) & 1, (kt + 1) * kGK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* a_s = sA[kt & 1];
    const bf16* b_s = sB[kt & 1];
#pragma unroll
    for (int kk = 0; kk < kGK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], a_s + (wm * 64 + i * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nn = wn * 32 + j * 16;
        if (B_ROW) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, b_s + kk * kLdBr + nn, kLdBr);
#pragma unroll
          for (int i = 0; i < 4; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        } else {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, b_s + nn * kLdBc + kk, kLdBc);
#pragma unroll
          for (int i = 0; i < 4; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sC + (wm * 64 + i * 16) * kLdCg + wn * 32 + j * 16, acc[i][j],
                              kLdCg, wmma::mem_row_major);
  __syncthreads();
  for (int c = tid; c < kGM * (kGN / 8); c += kGemmThreads) {
    const int r = c / (kGN / 8), cc = (c % (kGN / 8)) * 8;
    const int gm = m0 + r, gn = n0 + cc;
    if (gm >= M || gn >= Nc) continue;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float a = sC[r * kLdCg + cc + e];
      v[e] = bias == nullptr ? a
                             : (ROUND_BEFORE_BIAS ? bf16r(a) : a) + __bfloat162float(bias[gn + e]);
    }
    store8(C + size_t(gm) * Nc + gn, v);
  }
}

// Launch dense_gemm_kernel<B_ROW, ROUND_BEFORE_BIAS> on `stream`.
template <bool ROUND_BEFORE_BIAS>
cudaError_t launch_dense_gemm(const void* A, const void* B, const void* bias, void* C, int M,
                              int Nc, int Kr, bool b_row, cudaStream_t stream) {
  dim3 grid((Nc + kGN - 1) / kGN, (M + kGM - 1) / kGM);
  if (grid.y > 65535 || Kr % 8 || Nc % 8) return cudaErrorInvalidValue;
  auto kernel = b_row ? dense_gemm_kernel<true, ROUND_BEFORE_BIAS>
                      : dense_gemm_kernel<false, ROUND_BEFORE_BIAS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kGemmSmem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kGemmThreads, kGemmSmem, stream>>>(
      static_cast<const bf16*>(A), static_cast<const bf16*>(B), static_cast<const bf16*>(bias),
      static_cast<bf16*>(C), M, Nc, Kr);
  return cudaGetLastError();
}

}  // namespace
}  // namespace clip_dplm
