// Symmetric InfoNCE over scale·a·b^T, forward (row and column logsumexp)
// and the gradient pass, for Hopper (sm_90a).
//
// Replaces clip_dplm_tpu/ops/fused_infonce.py: `_sym_lse_kernel` (the
// shared-raw forward, pallas_call in `_sym_row_col_lse`) and
// `_sym_grad_kernel` (pallas_call in `_sym_grad_pass`, the recompute
// schedule of the backward). Neither kernel stores the B x B similarity.
//
//   sym_lse_kernel: one block per 32 rows of x. The rows stay in shared
//     memory while the block walks the columns of y in 64-wide tiles: each
//     raw tile x·y^T (bf16 operands, f32 accumulation, WMMA) is scaled, its
//     rows update an online max / sum (exact row lse at the end), and its
//     columns give one partial (max over the block's rows, sum of exp below
//     it) per row block. The caller combines the column partials with
//     torch.logsumexp, as the reference combines its own with
//     jax.nn.logsumexp. Padded columns are -inf; padded rows never weigh.
//   sym_grad_kernel: the same walk; it recomputes each raw tile, forms
//     p = exp(s - lse_row) + exp(s - lse_col), rounds p to bf16 and
//     accumulates acc += p·y (f32) in registers, and rowdot += sum(p·raw).
//     The caller runs it twice, (a, b) and (b, a), and does the scalar tail.
//
// The caller pads d to a multiple of 64 with zero columns (no change to any
// dot product); the grad kernel's accumulator covers 32 x d in registers
// (d <= 512: at most 64 f32 per thread).
//
// Bounds on the H100: at B = 8192, d = 512 the forward is 69 GFLOP and the
// grad pass 137 GFLOP per call, against 8 MB of operands: compute-bound.
// WMMA fragments are loaded from shared memory for every product, so the
// shared-memory bandwidth, not the tensor cores, sets the rate (wgmma with
// operands in shared memory descriptors is later work). The exps (67 M per
// pass) ride along.

#include "infonce_tiles.cuh"

namespace clip_dplm {
namespace {

__global__ void __launch_bounds__(kThreads, 2)
sym_lse_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
               const float* __restrict__ scale_p, float* __restrict__ row_lse,
               float* __restrict__ colmax, float* __restrict__ colsum, int m, int n, int dp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem lay(dp);
  bf16* xs = reinterpret_cast<bf16*>(smem + lay.x);
  bf16* ys = reinterpret_cast<bf16*>(smem + lay.y);
  float* ss = reinterpret_cast<float*>(smem + lay.s);
  float* mrow = reinterpret_cast<float*>(smem + lay.m);
  float* lrow = reinterpret_cast<float*>(smem + lay.l);
  const int r0 = blockIdx.x * kBM, rows = min(kBM, m - r0);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const float scale = *scale_p;
  stage(xs, lay.ld, x, r0, kBM, m, dp);
  if (threadIdx.x < kBM) {
    mrow[threadIdx.x] = -INFINITY;
    lrow[threadIdx.x] = 0.f;
  }
  for (int j0 = 0; j0 < n; j0 += kBN) {
    stage(ys, lay.ld, y, j0, kBN, n, dp);
    cp_async_wait<0>();
    __syncthreads();
    raw_tile(xs, ys, lay.ld, dp, ss);
    __syncthreads();
    // scaled scores, -inf past the last column
    for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      ss[r * kLdS + c] = j0 + c < n ? ss[r * kLdS + c] * scale : -INFINITY;
    }
    __syncthreads();
    // rows: online max / sum
    for (int r = warp; r < rows; r += kWarps) {
      const float v0 = ss[r * kLdS + lane], v1 = ss[r * kLdS + lane + 32];
      const float mt = warp_max(fmaxf(v0, v1));
      const float m_old = mrow[r], m_new = fmaxf(m_old, mt);
      const float e = warp_sum(expf(v0 - m_new) + expf(v1 - m_new));
      if (lane == 0) {
        lrow[r] = lrow[r] * expf(m_old - m_new) + e;
        mrow[r] = m_new;
      }
    }
    // columns: one partial per (row block, column)
    if (threadIdx.x < kBN && j0 + threadIdx.x < n) {
      const int c = threadIdx.x;
      float cm = -INFINITY;
      for (int r = 0; r < rows; ++r) cm = fmaxf(cm, ss[r * kLdS + c]);
      float cs = 0.f;
      for (int r = 0; r < rows; ++r) cs += expf(ss[r * kLdS + c] - cm);
      colmax[size_t(blockIdx.x) * n + j0 + c] = cm;
      colsum[size_t(blockIdx.x) * n + j0 + c] = cs;
    }
    __syncthreads();
  }
  if (threadIdx.x < rows)
    row_lse[r0 + threadIdx.x] = mrow[threadIdx.x] + logf(fmaxf(lrow[threadIdx.x], 1e-30f));
}

// NT: accumulator column fragments per warp; dp == 64 * NT
template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
sym_grad_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
                const float* __restrict__ scale_p, const float* __restrict__ lse_row,
                const float* __restrict__ lse_col, float* __restrict__ acc_out,
                float* __restrict__ rowdot, int m, int n, int dp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem lay(dp);
  const int ld = lay.ld;
  bf16* xs = reinterpret_cast<bf16*>(smem + lay.x);
  bf16* ys = reinterpret_cast<bf16*>(smem + lay.y);
  float* ss = reinterpret_cast<float*>(smem + lay.s);
  bf16* ps = reinterpret_cast<bf16*>(smem + lay.p);
  float* rd = reinterpret_cast<float*>(smem + lay.rowdot);
  const int r0 = blockIdx.x * kBM, rows = min(kBM, m - r0);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int rf = warp & 1, cf0 = warp >> 1;  // acc fragments (rf, cf0 + 4t)
  const float scale = *scale_p;
  stage(xs, ld, x, r0, kBM, m, dp);
  if (threadIdx.x < kBM) rd[threadIdx.x] = 0.f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) wmma::fill_fragment(acc[t], 0.f);

  for (int j0 = 0; j0 < n; j0 += kBN) {
    stage(ys, ld, y, j0, kBN, n, dp);
    cp_async_wait<0>();
    __syncthreads();
    raw_tile(xs, ys, ld, dp, ss);
    __syncthreads();
    // p = exp(s - lse_row) + exp(s - lse_col), 0 on padding; rowdot
    for (int r = warp; r < kBM; r += kWarps) {
      float dot = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        float p = 0.f;
        if (r < rows && j0 + c < n) {
          const float raw = ss[r * kLdS + c], s = raw * scale;
          p = expf(s - lse_row[r0 + r]) + expf(s - lse_col[j0 + c]);
          dot += p * raw;
        }
        ps[r * kLdP + c] = __float2bfloat16(p);
      }
      dot = warp_sum(dot);
      if (lane == 0) rd[r] += dot;
    }
    __syncthreads();
    // acc += bf16(p) · y_tile
    accumulate_py<NT>(acc, ps, ys, ld, rf, cf0);
    __syncthreads();
  }
  // acc_out is (round_up(m, 32), dp): whole fragments, padded rows included
#pragma unroll
  for (int t = 0; t < NT; ++t)
    wmma::store_matrix_sync(acc_out + size_t(r0 + rf * 16) * dp + (cf0 + 4 * t) * 16, acc[t], dp,
                            wmma::mem_row_major);
  if (threadIdx.x < rows) rowdot[r0 + threadIdx.x] = rd[threadIdx.x];
}

template <int NT>
cudaError_t launch_grad(const void* x, const void* y, const void* scale, const void* lse_row,
                        const void* lse_col, void* acc, void* rowdot, int m, int n, int dp,
                        cudaStream_t stream) {
  const size_t bytes = Smem(dp).total;
  cudaError_t err = cudaFuncSetAttribute(sym_grad_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  sym_grad_kernel<NT><<<(m + kBM - 1) / kBM, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(y), static_cast<const float*>(scale),
      static_cast<const float*>(lse_row), static_cast<const float*>(lse_col),
      static_cast<float*>(acc), static_cast<float*>(rowdot), m, n, dp);
  return cudaGetLastError();
}

}  // namespace
}  // namespace clip_dplm

using namespace clip_dplm;

// x (m, dp), y (n, dp) bf16, dp % 64 == 0 and dp <= 512; scale: one f32 on
// the device. row_lse (m); colmax/colsum (ceil(m/32), n) f32.
extern "C" int sym_infonce_lse(const void* x, const void* y, const void* scale, void* row_lse,
                               void* colmax, void* colsum, int m, int n, int dp, void* stream) {
  if (dp % 64 || dp > 512 || m < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = Smem(dp).total;
  cudaError_t err = cudaFuncSetAttribute(sym_lse_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  sym_lse_kernel<<<(m + kBM - 1) / kBM, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(y), static_cast<const float*>(scale),
      static_cast<float*>(row_lse), static_cast<float*>(colmax), static_cast<float*>(colsum), m,
      n, dp);
  return static_cast<int>(cudaGetLastError());
}

// acc (round_up(m, 32), dp) f32 = (P_row + P_col^T)·y with bf16 p; rowdot
// (m) f32 = rowsum(p·raw). lse_row (m), lse_col (n) f32.
extern "C" int sym_infonce_grad(const void* x, const void* y, const void* scale,
                                const void* lse_row, const void* lse_col, void* acc,
                                void* rowdot, int m, int n, int dp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dp) {
    case 64: err = launch_grad<1>(x, y, scale, lse_row, lse_col, acc, rowdot, m, n, dp, s); break;
    case 128: err = launch_grad<2>(x, y, scale, lse_row, lse_col, acc, rowdot, m, n, dp, s); break;
    case 192: err = launch_grad<3>(x, y, scale, lse_row, lse_col, acc, rowdot, m, n, dp, s); break;
    case 256: err = launch_grad<4>(x, y, scale, lse_row, lse_col, acc, rowdot, m, n, dp, s); break;
    case 320: err = launch_grad<5>(x, y, scale, lse_row, lse_col, acc, rowdot, m, n, dp, s); break;
    case 384: err = launch_grad<6>(x, y, scale, lse_row, lse_col, acc, rowdot, m, n, dp, s); break;
    case 448: err = launch_grad<7>(x, y, scale, lse_row, lse_col, acc, rowdot, m, n, dp, s); break;
    case 512: err = launch_grad<8>(x, y, scale, lse_row, lse_col, acc, rowdot, m, n, dp, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
