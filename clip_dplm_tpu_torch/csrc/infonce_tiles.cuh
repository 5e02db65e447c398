// Tiles of the symmetric InfoNCE's backward kernels (fused_infonce.cu): a block
// keeps 32 rows of one operand in shared memory and walks the rows of the
// other in 64-wide tiles, forming each raw tile x·y^T with bf16 WMMA products
// and f32 accumulation. d is padded by the caller to a multiple of 64 with
// zero columns (no dot product changes).
#pragma once

#include "common.cuh"

namespace clip_dplm {
namespace {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kBM = 32;  // rows of x per block
constexpr int kBN = 64;  // columns of y per tile
constexpr int kLdS = kBN + 4;  // f32 raw tile
constexpr int kLdP = kBN + 8;  // bf16 p tile

struct Smem {
  int ld;  // bf16 row pitch of the x and y tiles
  size_t x, y, s, p, rowdot, total;
  __host__ __device__ explicit Smem(int dp) {
    ld = dp + 8;
    size_t off = 0;
    x = off;      off += align128(size_t(kBM) * ld * sizeof(bf16));
    y = off;      off += align128(size_t(kBN) * ld * sizeof(bf16));
    s = off;      off += align128(size_t(kBM) * kLdS * sizeof(float));
    p = off;      off += align128(size_t(kBM) * kLdP * sizeof(bf16));
    rowdot = off; off += align128(kBM * sizeof(float));
    total = off;
  }
};

// rows [r0, r0 + rows) of src (n_valid real rows, pitch dp) into dst with
// pitch ld; rows past n_valid are zero
__device__ inline void stage(bf16* dst, int ld, const bf16* src, int r0, int rows, int n_valid,
                             int dp) {
  const int cpr = dp / 8;
  for (int c = threadIdx.x; c < rows * cpr; c += kThreads) {
    const int r = c / cpr, k = (c % cpr) * 8;
    const bool ok = r0 + r < n_valid;
    cp_async16(dst + r * ld + k, ok ? src + size_t(r0 + r) * dp + k : src, ok);
  }
  cp_async_commit();
}

// raw tile (kBM x kBN) = x_s · y_s^T into s_s: one 16x16 fragment per warp,
// its k loop split over two accumulators (two independent mma chains)
__device__ inline void raw_tile(const bf16* xs, const bf16* ys, int ld, int dp, float* ss) {
  const int warp = threadIdx.x / kWarp, rf = warp / 4, cf = warp % 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c0, c1;
  wmma::fill_fragment(c0, 0.f);
  wmma::fill_fragment(c1, 0.f);
  for (int k = 0; k < dp; k += 32) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b0, b1;
    wmma::load_matrix_sync(a0, xs + rf * 16 * ld + k, ld);
    wmma::load_matrix_sync(b0, ys + cf * 16 * ld + k, ld);
    wmma::load_matrix_sync(a1, xs + rf * 16 * ld + k + 16, ld);
    wmma::load_matrix_sync(b1, ys + cf * 16 * ld + k + 16, ld);
    wmma::mma_sync(c0, a0, b0, c0);
    wmma::mma_sync(c1, a1, b1, c1);
  }
#pragma unroll
  for (int i = 0; i < c0.num_elements; ++i) c0.x[i] += c1.x[i];
  wmma::store_matrix_sync(ss + rf * 16 * kLdS + cf * 16, c0, kLdS, wmma::mem_row_major);
}

// acc[t] (fragments (rf, cf0 + 4t) of the 32 x dp accumulator) += bf16 p
// tile (kBM x kBN) · y tile (kBN x dp)
template <int NT>
__device__ inline void accumulate_py(wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc,
                                     const bf16* ps, const bf16* ys, int ld, int rf, int cf0) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int cf = cf0 + 4 * t;
#pragma unroll
    for (int kk = 0; kk < kBN; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, ps + rf * 16 * kLdP + kk, kLdP);
      wmma::load_matrix_sync(b, ys + kk * ld + cf * 16, ld);
      wmma::mma_sync(acc[t], a, b, acc[t]);
    }
  }
}

// The same product with the p tile stored transposed: pt is kBN x kBM
// (row = walked row, column = own row, pitch ldp), read as a column-major
// A operand, so acc (32 x dp) += pt^T · x tile (kBN x dp).
template <int NT>
__device__ inline void accumulate_ptx(wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc,
                                      const bf16* pt, int ldp, const bf16* xs, int ld, int rf,
                                      int cf0) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int cf = cf0 + 4 * t;
#pragma unroll
    for (int kk = 0; kk < kBN; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, pt + kk * ldp + rf * 16, ldp);
      wmma::load_matrix_sync(b, xs + kk * ld + cf * 16, ld);
      wmma::mma_sync(acc[t], a, b, acc[t]);
    }
  }
}

}  // namespace
}  // namespace clip_dplm
