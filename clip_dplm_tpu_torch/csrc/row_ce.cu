// Row cross-entropy over scale·x·y^T with a column-validity count, for
// Hopper (sm_90a): the forward's row logsumexp and the two contractions of
// the backward. The hard-negative cache path runs them twice a step: a
// against [b; cache] with n_valid = B + cache_len, and b against a.
//
// Replaces clip_dplm_tpu/ops/fused_infonce.py: `_lse_kernel` (pallas_call in
// `_row_lse`), `_dx_kernel` and `_dy_kernel` (the two pallas_calls in
// `_softmax_contractions`). None of them stores the m x n similarity.
//
//   row_ce_lse_kernel: one block per 32 rows of x, which stay in shared
//     memory while the block walks the columns of y in 64-wide tiles (raw
//     tile x·y^T: bf16 operands, f32 accumulation, WMMA); each row keeps an
//     online max / sum of scale·raw + colmask, colmask = 0 below n_valid and
//     -1e30 from it on, as the reference's. n_valid is read from the device
//     (the cache's fill level lives there; the host never waits for it).
//   row_ce_grad_kernel<kDx = true> (dX): the same walk; each raw tile is
//     recomputed, p = exp(scale·raw + colmask - lse_row) (one exponential),
//     rounded to bf16 and accumulated acc += p·y (f32, registers), with
//     rowdot += sum(p·raw) in f32.
//   row_ce_grad_kernel<kDx = false> (dY): the roles swap. A block owns 32
//     rows of y (columns of the logits) and walks every row tile of x,
//     accumulating bf16(p)^T·x in registers and writing once: no atomics, so
//     runs repeat bit for bit. p = exp(scale·raw - lse_row) with no column
//     mask, as the reference's `_dy_kernel`; padded rows of x take p = 0.
//     The caller may ask for the first n_own rows of y only (the rows whose
//     gradient is read: on the cache path the cache's rows take none).
//
// A tile whose columns all lie at or past n_valid changes neither the online
// max / sum (exp(-1e30 - m) is 0 in f32) nor p·y, so the lse and dX kernels
// stop at the last valid column (for n_valid > 0): the unfilled part of the
// cache costs nothing.
//
// Bounds on the H100: at B = C = 8192, d = 512 and a full cache the a
// direction's lse is 137 GFLOP, dX 275 and dY (b's rows) 137, against
// ~25 MB of operands: compute-bound. As in fused_infonce.cu, WMMA fragments
// come from shared memory for every product, which sets the rate (wgmma is
// later work).

#include "infonce_tiles.cuh"

namespace clip_dplm {
namespace {

// Columns [0, end) a kernel walks: the valid prefix when there is one.
__device__ inline int walk_end(int nv, int n) { return nv > 0 ? nv : n; }

__global__ void __launch_bounds__(kThreads, 2)
row_ce_lse_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
                  const float* __restrict__ scale_p, const int* __restrict__ nvalid_p,
                  float* __restrict__ lse, int m, int n, int dp) {
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
  const int nv = max(0, min(*nvalid_p, n)), end = walk_end(nv, n);
  stage(xs, lay.ld, x, r0, kBM, m, dp);
  if (threadIdx.x < kBM) {
    mrow[threadIdx.x] = -INFINITY;
    lrow[threadIdx.x] = 0.f;
  }
  for (int j0 = 0; j0 < end; j0 += kBN) {
    stage(ys, lay.ld, y, j0, kBN, n, dp);
    cp_async_wait<0>();
    __syncthreads();
    raw_tile(xs, ys, lay.ld, dp, ss);
    __syncthreads();
    // rows: online max / sum of the scaled, masked scores
    for (int r = warp; r < rows; r += kWarps) {
      float v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        v[h] = ss[r * kLdS + c] * scale + (j0 + c < nv ? 0.f : kMaskBias);
      }
      const float mt = warp_max(fmaxf(v[0], v[1]));
      const float m_old = mrow[r], m_new = fmaxf(m_old, mt);
      const float e = warp_sum(expf(v[0] - m_new) + expf(v[1] - m_new));
      if (lane == 0) {
        lrow[r] = lrow[r] * expf(m_old - m_new) + e;
        mrow[r] = m_new;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < rows)
    lse[r0 + threadIdx.x] = mrow[threadIdx.x] + logf(fmaxf(lrow[threadIdx.x], 1e-30f));
}

// kDx: own = rows of x (m_own), walk = rows of y (n_walk, n_valid of them
// valid), lse indexed by own row; acc = P·y, rowdot = rowsum(p·raw).
// !kDx: own = rows of y (the first m_own), walk = rows of x (n_walk), lse
// indexed by walked row; acc = P^T·x. NT accumulator column fragments per
// warp; dp == 64 * NT.
template <int NT, bool kDx>
__global__ void __launch_bounds__(kThreads, 2)
row_ce_grad_kernel(const bf16* __restrict__ own, const bf16* __restrict__ walk,
                   const float* __restrict__ scale_p, const int* __restrict__ nvalid_p,
                   const float* __restrict__ lse, float* __restrict__ acc_out,
                   float* __restrict__ rowdot, int m_own, int n_walk, int dp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem lay(dp);
  const int ld = lay.ld;
  bf16* xs = reinterpret_cast<bf16*>(smem + lay.x);
  bf16* ys = reinterpret_cast<bf16*>(smem + lay.y);
  float* ss = reinterpret_cast<float*>(smem + lay.s);
  bf16* ps = reinterpret_cast<bf16*>(smem + lay.p);
  float* rd = reinterpret_cast<float*>(smem + lay.rowdot);
  const int r0 = blockIdx.x * kBM, rows = min(kBM, m_own - r0);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int rf = warp & 1, cf0 = warp >> 1;  // acc fragments (rf, cf0 + 4t)
  const float scale = *scale_p;
  const int nv = kDx ? max(0, min(*nvalid_p, n_walk)) : n_walk;
  const int end = walk_end(nv, n_walk);
  stage(xs, ld, own, r0, kBM, m_own, dp);
  if (threadIdx.x < kBM) rd[threadIdx.x] = 0.f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) wmma::fill_fragment(acc[t], 0.f);

  for (int j0 = 0; j0 < end; j0 += kBN) {
    stage(ys, ld, walk, j0, kBN, n_walk, dp);
    cp_async_wait<0>();
    __syncthreads();
    raw_tile(xs, ys, ld, dp, ss);
    __syncthreads();
    // p (0 on padding), rounded to bf16 for the product; rowdot in f32
    for (int r = warp; r < kBM; r += kWarps) {
      float dot = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h, j = j0 + c;
        float p = 0.f;
        if (r < rows && j < n_walk) {
          const float raw = ss[r * kLdS + c];
          if (kDx) {
            p = expf(raw * scale + (j < nv ? 0.f : kMaskBias) - lse[r0 + r]);
            dot += p * raw;
          } else {
            p = expf(raw * scale - lse[j]);
          }
        }
        ps[r * kLdP + c] = __float2bfloat16(p);
      }
      if (kDx) {
        dot = warp_sum(dot);
        if (lane == 0) rd[r] += dot;
      }
    }
    __syncthreads();
    accumulate_py<NT>(acc, ps, ys, ld, rf, cf0);
    __syncthreads();
  }
  // acc_out is (round_up(m_own, 32), dp): whole fragments, padded rows included
#pragma unroll
  for (int t = 0; t < NT; ++t)
    wmma::store_matrix_sync(acc_out + size_t(r0 + rf * 16) * dp + (cf0 + 4 * t) * 16, acc[t], dp,
                            wmma::mem_row_major);
  if (kDx && threadIdx.x < rows) rowdot[r0 + threadIdx.x] = rd[threadIdx.x];
}

template <int NT, bool kDx>
cudaError_t launch_grad(const void* own, const void* walk, const void* scale, const void* nvalid,
                        const void* lse, void* acc, void* rowdot, int m_own, int n_walk, int dp,
                        cudaStream_t stream) {
  const size_t bytes = Smem(dp).total;
  cudaError_t err = cudaFuncSetAttribute(row_ce_grad_kernel<NT, kDx>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  row_ce_grad_kernel<NT, kDx><<<(m_own + kBM - 1) / kBM, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(own), static_cast<const bf16*>(walk),
      static_cast<const float*>(scale), static_cast<const int*>(nvalid),
      static_cast<const float*>(lse), static_cast<float*>(acc), static_cast<float*>(rowdot),
      m_own, n_walk, dp);
  return cudaGetLastError();
}

template <bool kDx>
int dispatch_grad(const void* own, const void* walk, const void* scale, const void* nvalid,
                  const void* lse, void* acc, void* rowdot, int m_own, int n_walk, int dp,
                  void* stream) {
  if (m_own < 1 || n_walk < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dp) {
#define ROW_CE_CASE(NT)                                                                   \
  case 64 * NT:                                                                           \
    err = launch_grad<NT, kDx>(own, walk, scale, nvalid, lse, acc, rowdot, m_own, n_walk, \
                               dp, s);                                                    \
    break;
    ROW_CE_CASE(1) ROW_CE_CASE(2) ROW_CE_CASE(3) ROW_CE_CASE(4)
    ROW_CE_CASE(5) ROW_CE_CASE(6) ROW_CE_CASE(7) ROW_CE_CASE(8)
#undef ROW_CE_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // namespace
}  // namespace clip_dplm

using namespace clip_dplm;

// x (m, dp), y (n, dp) bf16, dp % 64 == 0 and dp <= 512; scale: one f32 and
// n_valid: one int32 on the device. lse (m) f32.
extern "C" int row_ce_lse(const void* x, const void* y, const void* scale, const void* nvalid,
                          void* lse, int m, int n, int dp, void* stream) {
  if (dp % 64 || dp > 512 || m < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = Smem(dp).total;
  cudaError_t err = cudaFuncSetAttribute(row_ce_lse_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  row_ce_lse_kernel<<<(m + kBM - 1) / kBM, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(y), static_cast<const float*>(scale),
      static_cast<const int*>(nvalid), static_cast<float*>(lse), m, n, dp);
  return static_cast<int>(cudaGetLastError());
}

// py (round_up(m, 32), dp) f32 = P·y with bf16 p; rowdot (m) f32 =
// rowsum(p·raw); P = exp(scale·x·y^T + colmask - lse), lse (m) f32.
extern "C" int row_ce_dx(const void* x, const void* y, const void* scale, const void* nvalid,
                         const void* lse, void* py, void* rowdot, int m, int n, int dp,
                         void* stream) {
  return dispatch_grad<true>(x, y, scale, nvalid, lse, py, rowdot, m, n, dp, stream);
}

// ptx (round_up(n_rows, 32), dp) f32 = P[:, :n_rows]^T·x with bf16 p, for
// the first n_rows rows of y; P = exp(scale·x·y^T - lse), lse (m) f32.
extern "C" int row_ce_dy(const void* x, const void* y, const void* scale, const void* lse,
                         void* ptx, int m, int n_rows, int dp, void* stream) {
  return dispatch_grad<false>(y, x, scale, nullptr, lse, ptx, nullptr, n_rows, m, dp, stream);
}
