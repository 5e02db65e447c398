// The symmetric InfoNCE's merged backward from the saved raw, for Hopper
// (sm_90a). The forward (row and column logsumexp, optionally saving the raw
// similarity as int16) is lse_walk.cu's; the recompute pass is row_ce.cu's
// wgmma kernel (`sym_infonce_grad`); the two passes from the saved raw (pass
// A, P·y and rowdot; pass B, P^T·x) are raw_grad.cu's wgmma kernel.
//
// Replaces clip_dplm_tpu/ops/fused_infonce.py: `_sym_grad_merged_kernel`
// (pallas_call in `_sym_grad_merged`).
//
//   sym_grad_merged_kernel: each tile of the saved int16 raw (m, ldq) is read
//     once (cp.async, 16-byte chunks; s = q · (scale / RAW_QSCALE), rowdot =
//     sum(p·q) / RAW_QSCALE) and contracted both ways. A cluster of 8 blocks
//     (32 rows each, 256 rows) walks the column tiles in step. Each block
//     forms its p tile and adds p·y to its acc_a (registers); after one
//     cluster barrier every block gathers the 8 p tiles of the cluster over
//     distributed shared memory and forms its share of the cluster's
//     (64 x dp) p^T·x tile: the 16-column d-fragments k, k + 8, ... for the
//     block of rank k, over the cluster's 256 rows, whose x columns it keeps
//     in shared memory for the whole walk. The tile is written to the
//     cluster's partial (one per 256 rows), and sum_partials_kernel adds the
//     ceil(m / 256) partials in a fixed order: no atomics anywhere; up to 256
//     rows the one partial is acc_b itself. The TPU kernel keeps the whole
//     (n, d) f32 sum in VMEM; no on-chip store of the H100 holds 16 MB, so
//     the partials go through device memory (at B = 8192, d = 512: 32
//     partials, 512 MB written and read once).
//
// The caller pads d to a multiple of 64 with zero columns (no change to any
// dot product); the accumulators cover 32 x d in registers (d <= 512: at
// most 64 f32 per thread). The saved raw's columns past n are masked.
//
// Bounds on the H100: at B = 8192, d = 512 the merged kernel is 137 GFLOP
// against the 128 MB int16 raw: bound by operations. It is a WMMA design
// (fragments loaded from shared memory for every product, so the
// shared-memory bandwidth, not the tensor cores, sets the rate); its wgmma
// redesign is later work (ROADMAP, Redesign B). The shape rule
// `ops/fused_infonce.py::_from_raw_merged` decides between it and
// raw_grad.cu's two passes (the passes at every batch).

#include <cooperative_groups.h>

#include "common.cuh"

namespace clip_dplm {
namespace {

namespace cg = cooperative_groups;
using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kBM = 32;  // rows of x per block
constexpr int kBN = 64;  // columns of y per tile
constexpr int kLdP = kBN + 8;   // bf16 p tile
constexpr int kLdQ = kBN + 8;   // int16 pitch of a 32 x 64 raw tile
constexpr int kCluster = 8;     // blocks of the merged kernel's cluster
constexpr int kCRows = kCluster * kBM;
static_assert(kThreads == kBM * kBN / 8, "one 8-entry chunk of the raw tile a thread");

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

// rows [r0, r0 + rows_tile) x columns [c0, c0 + cols_tile) of the saved raw
// (pitch ldq) into dst (pitch ldd) with 16-byte cp.async; rows past n_rows
// are zero
__device__ inline void stage_q(int16_t* dst, int ldd, const int16_t* src, int ldq, int r0,
                               int rows_tile, int c0, int cols_tile, int n_rows) {
  const int cpr = cols_tile / 8;
  for (int c = threadIdx.x; c < rows_tile * cpr; c += kThreads) {
    const int r = c / cpr, k = (c % cpr) * 8;
    const bool ok = r0 + r < n_rows;
    cp_async16(dst + r * ldd + k, ok ? src + size_t(r0 + r) * ldq + c0 + k : src, ok);
  }
  cp_async_commit();
}

// p tile (kBM x kBN, bf16, pitch kLdP) from the int16 raw tile qs of rows
// [r0, r0 + rows) and columns [j0, n): p = exp(s - lse_row) + exp(s -
// lse_col), s = q·sq, 0 on padding; rd[r] += sum(p·q)
__device__ inline void p_from_raw(const int16_t* qs, bf16* ps, float* rd, float sq,
                                  const float* lse_row, const float* lse_col, int r0, int rows,
                                  int j0, int n) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int r = warp; r < kBM; r += kWarps) {
    float dot = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane + 32 * h;
      float p = 0.f;
      if (r < rows && j0 + c < n) {
        const float qf = qs[r * kLdQ + c], s = qf * sq;
        p = expf(s - lse_row[r0 + r]) + expf(s - lse_col[j0 + c]);
        dot += p * qf;
      }
      ps[r * kLdP + c] = __float2bfloat16(p);
    }
    dot = warp_sum(dot);
    if (lane == 0) rd[r] += dot;
  }
}

// Shared memory of the merged kernel: the y tile, the int16 raw tile, the
// block's p tile (two, by step parity: the cluster reads one while the next
// is formed), the cluster's 8 gathered p tiles (256 x 64) and the cluster's
// x rows in the block's d-fragments (256 x nef·16).
struct MergedSmem {
  int ld, nef, xld;
  size_t y, q, p, pg, x, rowdot, total;
  __host__ __device__ explicit MergedSmem(int dp) {
    ld = dp + 8;
    nef = (dp / 16 + kCluster - 1) / kCluster;  // d-fragments a block owns, at most
    xld = nef * 16 + 8;
    size_t off = 0;
    y = off;      off += align128(size_t(kBN) * ld * sizeof(bf16));
    q = off;      off += align128(size_t(kBM) * kLdQ * sizeof(int16_t));
    p = off;      off += align128(size_t(2) * kBM * kLdP * sizeof(bf16));
    pg = off;     off += align128(size_t(kCRows) * kLdP * sizeof(bf16));
    x = off;      off += align128(size_t(kCRows) * xld * sizeof(bf16));
    rowdot = off; off += align128(kBM * sizeof(float));
    total = off;
  }
};

template <int NT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
sym_grad_merged_kernel(const int16_t* __restrict__ raw_q, int ldq, const bf16* __restrict__ x,
                       const bf16* __restrict__ y, const float* __restrict__ scale_p,
                       const float* __restrict__ lse_row, const float* __restrict__ lse_col,
                       float* __restrict__ acc_out, float* __restrict__ rowdot,
                       float* __restrict__ part, int m, int n, int dp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MergedSmem lay(dp);
  const int ld = lay.ld, xld = lay.xld;
  bf16* ys = reinterpret_cast<bf16*>(smem + lay.y);
  int16_t* qs = reinterpret_cast<int16_t*>(smem + lay.q);
  bf16* ps = reinterpret_cast<bf16*>(smem + lay.p);
  bf16* pg = reinterpret_cast<bf16*>(smem + lay.pg);
  bf16* xs = reinterpret_cast<bf16*>(smem + lay.x);
  float* rd = reinterpret_cast<float*>(smem + lay.rowdot);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cl = blockIdx.x / kCluster, R0 = cl * kCRows;
  const int r0 = blockIdx.x * kBM, rows = max(0, min(kBM, m - r0));
  const int warp = threadIdx.x / kWarp;
  const int rf = warp & 1, cf0 = warp >> 1;
  const float sq = *scale_p * kRawQInv;
  // this block's d-fragments of p^T·x: ef = rank + kCluster·u, u < nef
  const int nef = max(0, (dp / 16 - rank + kCluster - 1) / kCluster);
  float* part_cl = part + size_t(cl) * ldq * dp;

  // the cluster's x rows in this block's d-fragments, once
  for (int c = threadIdx.x; c < kCRows * nef * 2; c += kThreads) {
    const int r = c / (nef * 2), u = c % (nef * 2) / 2, h = c % 2;
    const bool ok = R0 + r < m;
    const int col = (rank + kCluster * u) * 16 + h * 8;
    cp_async16(xs + r * xld + u * 16 + h * 8, ok ? x + size_t(R0 + r) * dp + col : x, ok);
  }
  cp_async_commit();
  if (threadIdx.x < kBM) rd[threadIdx.x] = 0.f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) wmma::fill_fragment(acc[t], 0.f);

  for (int j0 = 0, step = 0; j0 < n; j0 += kBN, ++step) {
    bf16* pc = ps + (step & 1) * kBM * kLdP;
    stage_q(qs, kLdQ, raw_q, ldq, r0, kBM, j0, kBN, m);
    stage(ys, ld, y, j0, kBN, n, dp);
    cp_async_wait<0>();
    __syncthreads();
    p_from_raw(qs, pc, rd, sq, lse_row, lse_col, r0, rows, j0, n);
    __syncthreads();
    accumulate_py<NT>(acc, pc, ys, ld, rf, cf0);
    cluster.sync();  // every p tile of the cluster is complete
    // gather the cluster's p tiles: rows 32·k .. 32·k + 31 from rank k
    for (int k = 0; k < kCluster; ++k) {
      const bf16* src = cluster.map_shared_rank(pc, k);
      const int r = threadIdx.x / 8, c = threadIdx.x % 8 * 8;
      *reinterpret_cast<uint4*>(pg + (k * kBM + r) * kLdP + c) =
          *reinterpret_cast<const uint4*>(src + r * kLdP + c);
    }
    __syncthreads();
    // this block's fragments (cf, u) of the cluster's 64 x dp tile p^T·x
    for (int f = warp; f < 4 * nef; f += kWarps) {
      const int cf = f % 4, u = f / 4;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::fill_fragment(o, 0.f);
      for (int kk = 0; kk < kCRows; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, pg + kk * kLdP + cf * 16, kLdP);
        wmma::load_matrix_sync(b, xs + kk * xld + u * 16, xld);
        wmma::mma_sync(o, a, b, o);
      }
      wmma::store_matrix_sync(part_cl + size_t(j0 + cf * 16) * dp + (rank + kCluster * u) * 16, o,
                              dp, wmma::mem_row_major);
    }
  }
  cluster.sync();  // no block leaves while another may still read its p tiles
  if (r0 < m) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
      wmma::store_matrix_sync(acc_out + size_t(r0 + rf * 16) * dp + (cf0 + 4 * t) * 16, acc[t],
                              dp, wmma::mem_row_major);
  }
  if (threadIdx.x < rows) rowdot[r0 + threadIdx.x] = rd[threadIdx.x] * kRawQInv;
}

// out = sum over c of part[c] (nparts partials of n4 float4 each), in the
// order c = 0, 1, ...
__global__ void sum_partials_kernel(const float4* __restrict__ part, float4* __restrict__ out,
                                    int n4, int nparts) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += gridDim.x * blockDim.x) {
    float4 s = part[i];
    for (int c = 1; c < nparts; ++c) {
      const float4 v = part[size_t(c) * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out[i] = s;
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The merged kernel's arguments, as its C entry takes them.
struct FromRaw {
  const int16_t* raw_q;
  int ldq;
  const bf16 *x, *y;
  const float *scale, *lse_row, *lse_col;
  float *acc_a, *rowdot, *part, *acc_b;
  int m, n, dp;
  cudaStream_t stream;
};

template <int NT>
cudaError_t launch_merged(const FromRaw& a) {
  const size_t bytes = MergedSmem(a.dp).total;
  cudaError_t err = prepare(sym_grad_merged_kernel<NT>, bytes);
  if (err != cudaSuccess) return err;
  // one cluster's partial is the whole of acc_b: no sum to take
  const int clusters = (a.m + kCRows - 1) / kCRows;
  sym_grad_merged_kernel<NT><<<clusters * kCluster, kThreads, bytes, a.stream>>>(
      a.raw_q, a.ldq, a.x, a.y, a.scale, a.lse_row, a.lse_col, a.acc_a, a.rowdot,
      clusters > 1 ? a.part : a.acc_b, a.m, a.n, a.dp);
  err = cudaGetLastError();
  if (err != cudaSuccess || clusters == 1) return err;
  const int n4 = a.ldq * a.dp / 4, blocks = (n4 + kThreads - 1) / kThreads;
  sum_partials_kernel<<<blocks < 132 * 8 ? blocks : 132 * 8, kThreads, 0, a.stream>>>(
      reinterpret_cast<const float4*>(a.part), reinterpret_cast<float4*>(a.acc_b), n4, clusters);
  return cudaGetLastError();
}

// One launcher for each dp = 64·NT, NT = 1..8
int dispatch_merged(const FromRaw& a) {
  if (a.dp % 64 || a.dp > 512 || a.m < 1 || a.n < 1 || a.ldq % 64 || a.ldq < a.n)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (a.dp / 64) {
    case 1: return static_cast<int>(launch_merged<1>(a));
    case 2: return static_cast<int>(launch_merged<2>(a));
    case 3: return static_cast<int>(launch_merged<3>(a));
    case 4: return static_cast<int>(launch_merged<4>(a));
    case 5: return static_cast<int>(launch_merged<5>(a));
    case 6: return static_cast<int>(launch_merged<6>(a));
    case 7: return static_cast<int>(launch_merged<7>(a));
    default: return static_cast<int>(launch_merged<8>(a));
  }
}

}  // namespace
}  // namespace clip_dplm

using namespace clip_dplm;

// From the saved raw_q (m, ldq) int16, lse_row (m), lse_col (n) f32, with
// p = exp(s - lse_row) + exp(s - lse_col), s = raw_q · scale / RAW_QSCALE,
// bf16 p in the products, both contractions in one pass over raw_q and the
// sum of the per-256-row partials: acc_a (round_up(m, 32), dp) f32 = P·y,
// rowdot (m) = rowsum(p·raw_q) / RAW_QSCALE; part (ceil(m / 256), ldq, dp) f32 scratch
// (unread, and may be null, for m <= 256: the one partial is acc_b);
// acc_b (ldq, dp) f32 = P^T·x.
extern "C" int sym_infonce_grad_merged(const void* raw_q, int ldq, const void* x, const void* y,
                                       const void* scale, const void* lse_row,
                                       const void* lse_col, void* acc_a, void* rowdot,
                                       void* part, void* acc_b, int m, int n, int dp,
                                       void* stream) {
  FromRaw a{static_cast<const int16_t*>(raw_q), ldq, static_cast<const bf16*>(x),
            static_cast<const bf16*>(y), static_cast<const float*>(scale),
            static_cast<const float*>(lse_row), static_cast<const float*>(lse_col),
            static_cast<float*>(acc_a), static_cast<float*>(rowdot), static_cast<float*>(part),
            static_cast<float*>(acc_b), m, n, dp, static_cast<cudaStream_t>(stream)};
  return dispatch_merged(a);
}
