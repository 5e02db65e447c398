// Row cross-entropy over scale·x·y^T with a column-validity count, for
// Hopper (sm_90a): the two contractions of the backward. The hard-negative
// cache path runs them twice a step: a against [b; cache] with n_valid = B +
// cache_len, and b against a. (The forward's row logsumexp is
// lse_walk.cu's row_ce_lse.)
//
// Replaces clip_dplm_tpu/ops/fused_infonce.py: `_dx_kernel` and `_dy_kernel`
// (the two pallas_calls in `_softmax_contractions`). Neither stores the m x n
// similarity.
//
// row_ce_grad_kernel<KB, kDx>, dp = 64·KB, is the backward of both
// directions. A block owns 64 rows ("own") and walks the rows of the other
// operand ("walk") in 64-row tiles:
//   kDx (row_ce_dx): own = rows of x, walk = rows of y; per tile
//     S = x·y_tile^T, p = exp(scale·S + colmask - lse[own row]) (one
//     exponential), acc += bf16(p)·y_tile, rowdot += sum(p·S) in f32;
//   !kDx (row_ce_dy): own = the first n_own rows of y (on the cache path
//     b's rows: the cache takes no gradient), walk = rows of x; per tile
//     S^T = y_own·x_tile^T, p = exp(scale·S^T - lse[walked row]) with no
//     column mask, as the reference's `_dy_kernel`, acc += bf16(p)·x_tile.
// p is 0 on walked rows past n_walk. A tile whose columns all lie at or past
// n_valid adds nothing to p·y (exp(-1e30 - lse) is 0 in f32), so the dX
// kernel stops at the last valid column (for n_valid > 0): the unfilled part
// of the cache costs nothing.
//
// What bounds it on the H100: at B = C = 8192, d = 512 and a full cache the
// a direction's dX is 4·8192·13192·512 = 221 GFLOP (0.224 ms at 989
// TFLOP/s) and dY (b's rows) 137, against ~25 MB of operands: the tensor
// cores. So the design is the flash forward's (flash_attention.cu), S on
// the tensor cores and P·V with P from registers, at d = 512:
//  * the products are warpgroup wgmma (wgmma.cuh): S is m64n64k16 with both
//    operands K-major in shared memory; acc += P·walk takes P as bf16 pairs
//    in registers (the A fragment) and the walked tile MN-major (the
//    transpose bit), one m64n256k16 a k16 step where a warpgroup holds 256
//    columns (dp = 512), m64n64k16 a block below. One walked tile in its
//    SW128 layout (dp/64 blocks of 64 rows x 64 columns) is the K-major B of
//    S and the MN-major B of P·walk: it is loaded once;
//  * the accumulator is split by columns: 64 x 512 f32 is 256 registers a
//    thread in one warpgroup, more than a thread has, so a block is two
//    warpgroups over the same 64 own rows, warpgroup w owning the 64-column
//    blocks [w·ceil(KB/2), ...) of acc (128 registers at KB = 8) and the same
//    blocks of d as its K slice of S: each forms a partial S over half of d,
//    and no product is done twice (forming the whole S in each warpgroup, 1.5x
//    the products and no exchange, ran 3-7 % slower: PERF.md);
//  * the exponentials are split too: warpgroup h takes walked columns
//    [32h, 32h + 32). Through shared memory it hands the other its partial
//    S of the other's half, adds the other's partial of its own (each entry
//    summed once), forms p there (one exponential an entry in the block),
//    rounds it to the bf16 A-fragment registers of its two k16 steps and
//    hands those over (float4 and uint4 stores in a thread-linear layout, no
//    bank conflict); rowdot is summed per half and the halves added once at
//    the end. A tile wholly below n_valid (dX) or n_walk (dY) forms p with
//    no per-entry mask, which was the largest single cost (PERF.md);
//  * the own tile arrives once by TMA, the walked tiles through a ring of two
//    slots (one thread issues the boxes, an mbarrier a slot; rows past the
//    end arrive as zeros); a slot is refilled once both warpgroups' products
//    on it have retired, so the copy of tile j+2 runs under tile j+1. A tile
//    runs S, the two exchanges and P·walk in series (three barriers):
//    issuing S of tile j+1 under p of tile j needs the slot of tile j+1
//    before tile j-1's is free, a third slot, which does not fit at dp = 512;
//  * dY's lse of the walked rows (8 a thread a tile) is read from device
//    memory while S is on the tensor cores; dX's of the own rows once;
//  * f32 out: each thread stores its accumulator as float2s, valid own rows
//    only, so the outputs are (m_own, dp) with no padded rows.
// Shared memory at dp = 512 (bytes): own tile 65,536; a walked stage of 64
// rows 65,536, two of them; the S exchange 64 x 64 x 4 = 16,384 and the p
// exchange 8,192; barriers 24; the 1024-byte alignment of the SW128 tiles:
// 222,232 of the 232,448 a block may have, one block (256 threads, 214-218
// registers, no spill) an SM, 128 blocks on 132 SMs at m = 8192. A third
// stage would need 65,536 more. Walked tiles of 32 rows (32 KB a stage, four
// stages and a 16 KB exchange: 214,056 bytes; S of the next tile issued
// under p of this one) ran 26-55 % slower: S as an m64n32k16 tile from
// shared memory asks 1.5x the shared-memory rate, and each tile pays its
// barriers (PERF.md). At dp = 64·KB the block holds 8,192·KB·3 + 24,576 +
// 1,048 bytes.
// Every output is summed in one block in a fixed order (no atomics, no split
// of the walk across blocks), so two launches are equal byte for byte.

#include <string.h>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace clip_dplm {
namespace {

// Columns [0, end) a kernel walks: the valid prefix when there is one.
__device__ inline int walk_end(int nv, int n) { return nv > 0 ? nv : n; }

constexpr int kGradRows = 64;      // own rows a block: wgmma's M
constexpr int kGradTile = 64;      // walked rows a tile: S's N, P·walk's K
constexpr int kGradThreads = 256;  // two warpgroups
constexpr int kGradStages = 2;     // walked tiles in the ring

// Shared memory of row_ce_grad_kernel<KB, *>: the own tile, the ring of
// walked tiles (each KB SW128 blocks of 64 rows x 64 columns), the S
// exchange (each warpgroup's f32 partial of the other's 32 columns, four
// float4s a thread), the p exchange (each warpgroup's bf16 A fragments of its
// own 32 columns, two uint4s a thread), the ring's mbarriers and the own
// tile's.
template <int KB>
struct GradSmem {
  static constexpr size_t kTile = size_t(kGradTile) * 64 * KB * sizeof(bf16);
  static constexpr size_t kOwn = 0;
  static constexpr size_t kWalk = kOwn + size_t(kGradRows) * 64 * KB * sizeof(bf16);
  static constexpr size_t kXchg = kWalk + kGradStages * kTile;
  static constexpr size_t kPxchg = kXchg + size_t(kGradRows) * kGradTile * sizeof(float);
  static constexpr size_t kBar = kPxchg + size_t(kGradRows) * kGradTile * sizeof(bf16);
  static constexpr size_t kBytes = kBar + (kGradStages + 1) * sizeof(uint64_t) + 1024;
  static_assert(kBytes <= kMaxSmem, "the block's shared memory");
};

// kDx: own = rows of x (m_own), walk = rows of y (n_walk, n_valid of them
// valid), lse indexed by own row; acc = P·y, rowdot = rowsum(p·raw).
// !kDx: own = rows of y (the first m_own), walk = rows of x (n_walk), lse
// indexed by walked row; acc = P^T·x. acc_out is (m_own, 64·KB).
template <int KB, bool kDx>
__global__ void __launch_bounds__(kGradThreads, 1)
row_ce_grad_kernel(const __grid_constant__ CUtensorMap tm_own,
                   const __grid_constant__ CUtensorMap tm_walk, const float* __restrict__ scale_p,
                   const int* __restrict__ nvalid_p, const float* __restrict__ lse,
                   float* __restrict__ acc_out, float* __restrict__ rowdot, int m_own,
                   int n_walk) {
  using L = GradSmem<KB>;
  constexpr int kDp = 64 * KB;
  constexpr int kHalf = (KB + 1) / 2;  // warpgroup 0's 64-column blocks; warpgroup 1: KB / 2
  constexpr int kBlock = kGradTile * 64;  // elements of one 64-column block of a tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* sOwn = reinterpret_cast<bf16*>(smem + L::kOwn);
  bf16* sWalk = reinterpret_cast<bf16*>(smem + L::kWalk);
  float4* xchg = reinterpret_cast<float4*>(smem + L::kXchg);
  uint4* pxchg = reinterpret_cast<uint4*>(smem + L::kPxchg);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);  // one a ring slot
  uint64_t* own_full = full + kGradStages;

  const int r0 = blockIdx.x * kGradRows;
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128, lane = tid % kWarp;
  const int g = lane >> 2, t = lane & 3;  // the accumulator's row group and column pair
  const int row = r0 + (wt / kWarp) * 16 + g;  // own row of s[4n], s[4n + 1]; row + 8: the rest
  const int blk0 = wg ? kHalf : 0, nblk = wg ? KB - kHalf : kHalf;  // this warpgroup's blocks
  const float scale = *scale_p;
  const int nv = kDx ? max(0, min(*nvalid_p, n_walk)) : n_walk;
  const int n_tiles = (walk_end(nv, n_walk) + kGradTile - 1) / kGradTile;

  // walked tile jt into ring slot jt % kGradStages, from one thread
  auto load_walk = [&](int jt) {
    const int sl = jt % kGradStages;
    mbar_expect_tx(&full[sl], unsigned(L::kTile));
    for (int b = 0; b < KB; ++b)
      tma_box_2d(sWalk + sl * (KB * kBlock) + b * kBlock, &tm_walk, b * 64, jt * kGradTile,
                 &full[sl]);
  };
  if (tid == 0) {
    for (int i = 0; i <= kGradStages; ++i) mbar_init(&full[i]);
    mbar_fence_init();
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_own))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_walk))
                 : "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(own_full, unsigned(kGradRows) * kDp * sizeof(bf16));
    for (int b = 0; b < KB; ++b)
      tma_box_2d(sOwn + b * (kGradRows * 64), &tm_own, b * 64, r0, own_full);
    for (int jt = 0; jt < kGradStages && jt < n_tiles; ++jt) load_walk(jt);
  }

  float lse_own[2] = {0.f, 0.f};
  if (kDx)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row + 8 * i < m_own) lse_own[i] = lse[row + 8 * i];
  float acc[kHalf * 32];  // 64-column block b at acc[32 b ..]
#pragma unroll
  for (int i = 0; i < kHalf * 32; ++i) acc[i] = 0.f;
  float rd[2] = {0.f, 0.f};  // rowdot of rows row, row + 8 over this thread's columns
  mbar_wait(own_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int sl = j % kGradStages, j0 = j * kGradTile;
    const bf16* tW = sWalk + sl * (KB * kBlock);
    mbar_wait(&full[sl], (j / kGradStages) & 1);

    // this warpgroup's partial S over its blocks of d; both operands K-major
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;  // a warpgroup with no block (KB = 1) adds 0
    wgmma_fence();
#pragma unroll
    for (int b = 0; b < kHalf; ++b)
      if (b < nblk)
#pragma unroll
        for (int c = 0; c < 4; ++c)  // a k16 step: 32 bytes along the 128-byte row
          wgmma_m64n64k16_ss(s, gmma_desc(sOwn + (blk0 + b) * (kGradRows * 64) + c * 16, 16, 1024),
                             gmma_desc(tW + (blk0 + b) * kBlock + c * 16, 16, 1024),
                             b > 0 || c > 0);
    wgmma_commit();
    // dY: the lse of the walked rows whose p this thread forms (warpgroup
    // h's columns, below), read while the products run
    float lw[8];
    if (!kDx)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = j0 + 32 * wg + 8 * n + 2 * t + e;
          lw[2 * n + e] = c < n_walk ? lse[c] : 0.f;
        }
    wgmma_wait<0>();
    fence_regs(s);

    // Warpgroup h forms p of walked columns [32h, 32h + 32) only (n-tiles
    // 4h .. 4h+3 of the accumulator, s[16h ..]): it publishes its partial S
    // of the other half, adds the other's partial of its own, forms p there
    // and publishes it as the A fragment of k-steps 2h, 2h+1 (pa), which the
    // other warpgroup reads; so each entry's S is summed once and each
    // exponential taken once.
    // (h is a constant in each call below, so s and pa stay in registers.)
    uint32_t pa[4][4];
    auto publish_s = [&](const int h) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        xchg[(h * 4 + q) * 128 + wt] =
            make_float4(s[16 * (1 - h) + 4 * q], s[16 * (1 - h) + 4 * q + 1],
                        s[16 * (1 - h) + 4 * q + 2], s[16 * (1 - h) + 4 * q + 3]);
    };
    auto form_p = [&](const int h) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 o = xchg[((1 - h) * 4 + q) * 128 + wt];
        s[16 * h + 4 * q] += o.x;
        s[16 * h + 4 * q + 1] += o.y;
        s[16 * h + 4 * q + 2] += o.z;
        s[16 * h + 4 * q + 3] += o.w;
      }
      // p (0 past n_walk); rowdot from the unrounded p and the f32 raw. A
      // tile wholly below n_valid (dX) or n_walk (dY) takes no mask.
      auto exps = [&](bool masked) {
#pragma unroll
        for (int n = 4 * h; n < 4 * h + 4; ++n)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = 4 * n + 2 * i + e, c = j0 + 8 * n + 2 * t + e;
              const float raw = s[idx];
              float p = 0.f;
              if (!masked || c < n_walk) {
                if (kDx) {
                  p = expf(raw * scale + (!masked || c < nv ? 0.f : kMaskBias) - lse_own[i]);
                  rd[i] += p * raw;
                } else {
                  p = expf(raw * scale - lw[2 * (n - 4 * h) + e]);
                }
              }
              s[idx] = p;
            }
      };
      if (j0 + kGradTile <= nv)
        exps(false);
      else
        exps(true);
      // n-tiles 2kk, 2kk+1 of the S accumulator are the A fragment of the
      // kk-th 16 walked rows
#pragma unroll
      for (int kk = 2 * h; kk < 2 * h + 2; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        pxchg[(h * 2 + kk - 2 * h) * 128 + wt] =
            make_uint4(pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3]);
      }
    };
    auto take_p = [&](const int h) {
#pragma unroll
      for (int kk = 2 * (1 - h); kk < 2 * (1 - h) + 2; ++kk) {
        const uint4 o = pxchg[((1 - h) * 2 + kk - 2 * (1 - h)) * 128 + wt];
        pa[kk][0] = o.x;
        pa[kk][1] = o.y;
        pa[kk][2] = o.z;
        pa[kk][3] = o.w;
      }
    };
    if (wg == 0)
      publish_s(0);
    else
      publish_s(1);
    __syncthreads();
    if (wg == 0)
      form_p(0);
    else
      form_p(1);
    __syncthreads();
    if (wg == 0)
      take_p(0);
    else
      take_p(1);

    // acc += P·walk tile: P from registers, the tile MN-major
    wgmma_fence();
    bool wide = false;
    if constexpr (kHalf == 4) {
      if (nblk == 4) {  // the warpgroup's 256 columns in one product a k16 step
        wide = true;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n256k16_rs<1>(acc, pa[kk],
                                 gmma_desc(tW + blk0 * kBlock + kk * 16 * 64, kBlock * 2, 1024),
                                 true);
      }
    }
    if (!wide)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int b = 0; b < kHalf; ++b)
          if (b < nblk)
            wgmma_m64n64k16_rs<1>(*reinterpret_cast<float(*)[32]>(acc + 32 * b), pa[kk],
                                  gmma_desc(tW + (blk0 + b) * kBlock + kk * 16 * 64,
                                            kGradTile * 128, 1024),
                                  true);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
    // both warpgroups are done with the slot and with the exchange
    __syncthreads();
    if (tid == 0 && j + kGradStages < n_tiles) load_walk(j + kGradStages);
  }

  // epilogue: float2 stores of the valid own rows
#pragma unroll
  for (int b = 0; b < kHalf; ++b)
    if (b < nblk)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (row + 8 * i < m_own) {
          float* out = acc_out + size_t(row + 8 * i) * kDp + (blk0 + b) * 64 + 2 * t;
#pragma unroll
          for (int n = 0; n < 8; ++n)
            *reinterpret_cast<float2*>(out + 8 * n) =
                make_float2(acc[32 * b + 4 * n + 2 * i], acc[32 * b + 4 * n + 2 * i + 1]);
        }
  // rowdot: each warpgroup's sum over its half of every tile, summed over
  // the quad, then warpgroup 0's plus warpgroup 1's (through the exchange,
  // free since the loop's last barrier)
  if (kDx) {
    float* half_sum = reinterpret_cast<float*>(xchg);
    float v[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      v[i] = rd[i];
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], 1);
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], 2);
      if (wg == 1 && t == 0) half_sum[row - r0 + 8 * i] = v[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (wg == 0 && t == 0 && row + 8 * i < m_own)
        rowdot[row + 8 * i] = v[i] + half_sum[row - r0 + 8 * i];
  }
}

// Calls of row_ce_dx (0) and row_ce_dy (1) that launched row_ce_grad_kernel
// since the library was loaded.
int g_grad_calls[2] = {0, 0};

template <int KB, bool kDx>
cudaError_t launch_grad(const void* own, const void* walk, const void* scale, const void* nvalid,
                        const void* lse, void* acc, void* rowdot, int m_own, int n_walk,
                        cudaStream_t stream) {
  constexpr int kDp = 64 * KB;
  // own (m_own, dp) and walk (n_walk, dp) row-major, as boxes of 64 columns
  // by 64 rows
  const cuuint64_t own_dims[2] = {cuuint64_t(kDp), cuuint64_t(m_own)};
  const cuuint64_t walk_dims[2] = {cuuint64_t(kDp), cuuint64_t(n_walk)};
  const cuuint64_t strides[1] = {cuuint64_t(kDp) * sizeof(bf16)};
  const cuuint32_t box[2] = {64, 64};
  CUtensorMap tm_own, tm_walk;
  memset(&tm_own, 0, sizeof(tm_own));
  memset(&tm_walk, 0, sizeof(tm_walk));
  if (!tensor_map(&tm_own, own, 2, own_dims, strides, box) ||
      !tensor_map(&tm_walk, walk, 2, walk_dims, strides, box))
    return cudaErrorInvalidValue;  // e.g. a base off 16 bytes
  const size_t bytes = GradSmem<KB>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(row_ce_grad_kernel<KB, kDx>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  row_ce_grad_kernel<KB, kDx><<<(m_own + kGradRows - 1) / kGradRows, kGradThreads, bytes,
                                stream>>>(
      tm_own, tm_walk, static_cast<const float*>(scale), static_cast<const int*>(nvalid),
      static_cast<const float*>(lse), static_cast<float*>(acc), static_cast<float*>(rowdot),
      m_own, n_walk);
  err = cudaGetLastError();
  g_grad_calls[kDx ? 0 : 1] += err == cudaSuccess;
  return err;
}

template <bool kDx>
int dispatch_grad(const void* own, const void* walk, const void* scale, const void* nvalid,
                  const void* lse, void* acc, void* rowdot, int m_own, int n_walk, int dp,
                  void* stream) {
  if (m_own < 1 || n_walk < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dp) {
#define ROW_CE_CASE(KB)                                                                         \
  case 64 * KB:                                                                                 \
    err = launch_grad<KB, kDx>(own, walk, scale, nvalid, lse, acc, rowdot, m_own, n_walk, s); \
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

// py (m, dp) f32 = P·y with bf16 p; rowdot (m) f32 = rowsum(p·raw);
// P = exp(scale·x·y^T + colmask - lse), lse (m) f32. x and y 16-byte
// aligned (the tensor maps).
extern "C" int row_ce_dx(const void* x, const void* y, const void* scale, const void* nvalid,
                         const void* lse, void* py, void* rowdot, int m, int n, int dp,
                         void* stream) {
  return dispatch_grad<true>(x, y, scale, nvalid, lse, py, rowdot, m, n, dp, stream);
}

// ptx (n_rows, dp) f32 = P[:, :n_rows]^T·x with bf16 p, for the first
// n_rows rows of y; P = exp(scale·x·y^T - lse), lse (m) f32. x and y
// 16-byte aligned.
extern "C" int row_ce_dy(const void* x, const void* y, const void* scale, const void* lse,
                         void* ptx, int m, int n_rows, int dp, void* stream) {
  return dispatch_grad<false>(y, x, scale, nullptr, lse, ptx, nullptr, n_rows, m, dp, stream);
}

// Calls of row_ce_dx (0) and row_ce_dy (1) that launched the wgmma kernel
// row_ce_grad_kernel since the library was loaded.
extern "C" int row_ce_grad_calls(int which) {
  return which == 0 || which == 1 ? g_grad_calls[which] : -1;
}
