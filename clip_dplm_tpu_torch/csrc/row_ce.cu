// Row cross-entropy over scale·x·y^T with a column-validity count, and the
// symmetric InfoNCE's recompute pass, for Hopper (sm_90a): the contractions
// of both backwards. The hard-negative cache path runs the row CE's twice a
// step: a against [b; cache] with n_valid = B + cache_len, and b against a.
// The symmetric loss runs its recompute pass twice a step, (a, b) and (b, a),
// under `fused_materialize_raw="never"` and, under "auto", past the int16
// raw's 640 MiB (B > 18,317). (The forwards' logsumexps are lse_walk.cu's.)
//
// Replaces clip_dplm_tpu/ops/fused_infonce.py: `_dx_kernel` and `_dy_kernel`
// (the two pallas_calls in `_softmax_contractions`) and `_sym_grad_kernel`
// (the pallas_call in `_sym_grad_pass`). None stores the m x n similarity.
//
// row_ce_grad_kernel<KB, kMode>, dp = 64·KB, is the backward of all three.
// A block owns 64 rows ("own") and walks the rows of the other operand
// ("walk") in 64-row tiles:
//   kDx (row_ce_dx): own = rows of x, walk = rows of y; per tile
//     S = x·y_tile^T, p = exp(scale·S + colmask - lse[own row]) (one
//     exponential), acc += bf16(p)·y_tile, rowdot += sum(p·S) in f32;
//   kDy (row_ce_dy): own = the first n_own rows of y (on the cache path
//     b's rows: the cache takes no gradient), walk = rows of x; per tile
//     S^T = y_own·x_tile^T, p = exp(scale·S^T - lse[walked row]) with no
//     column mask, as the reference's `_dy_kernel`, acc += bf16(p)·x_tile;
//   kSym (sym_infonce_grad): own = rows of x, walk = rows of y; per tile
//     S = x·y_tile^T, p = exp(scale·S - lse_row[own]) + exp(scale·S -
//     lse_col[walked]) (two exponentials an entry, in the exp2 domain below),
//     acc += bf16(p)·y_tile, rowdot += sum(p·S) in f32; no column mask.
// p is 0 on walked rows past n_walk (they arrive as zeros, so S = 0 there,
// and the mask keeps exp(-lse) out). A tile whose columns all lie at or past
// n_valid adds nothing to p·y (exp(-1e30 - lse) is 0 in f32), so the dX
// kernel stops at the last valid column (for n_valid > 0): the unfilled part
// of the cache costs nothing.
//
// What bounds it on the H100: at B = C = 8192, d = 512 and a full cache the
// a direction's dX is 4·8192·13192·512 = 221 GFLOP (0.224 ms at 989
// TFLOP/s) and dY (b's rows) 137, against ~25 MB of operands; the symmetric
// pass 137 GFLOP (0.139 ms) a call at B = 8192 and 2.2 TFLOP (2.22 ms) at
// 32768: the tensor cores. So the design is the flash forward's
// (flash_attention.cu), S on the tensor cores and P·V with P from registers,
// at d = 512:
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
//    summed once), forms p there (each exponential taken once in the block),
//    rounds it to the bf16 A-fragment registers of its two k16 steps and
//    hands those over (float4 and uint4 stores in a thread-linear layout, no
//    bank conflict); rowdot is summed per half and the halves added once at
//    the end. A tile wholly below n_valid (dX) or n_walk (dY, sym) forms p
//    with no per-entry mask, which was the largest single cost (PERF.md);
//  * the symmetric pass's two exponentials are taken in the exp2 domain,
//    2^((s - lse)·log2 e) after the reference's subtraction s - lse, each
//    one ex2.approx.ftz (as raw_grad.cu's passes form the same p);
//  * the own tile arrives once by TMA, the walked tiles through a ring of two
//    slots (one thread issues the boxes, an mbarrier a slot; rows past the
//    end arrive as zeros); a slot is refilled once both warpgroups' products
//    on it have retired, so the copy of tile j+2 runs under tile j+1. A tile
//    runs S, the two exchanges and P·walk in series (three barriers):
//    issuing S of tile j+1 under p of tile j needs the slot of tile j+1
//    before tile j-1's is free, a third slot, which does not fit at dp = 512;
//  * the lse of the walked rows (dY, sym: 8 a thread a tile) is read from
//    device memory while S is on the tensor cores; that of the own rows
//    (dX, sym) once;
//  * f32 out: each thread stores its accumulator as float2s, valid own rows
//    only, so the outputs are (m_own, dp) with no padded rows.
// Shared memory at dp = 512 (bytes): own tile 65,536; a walked stage of 64
// rows 65,536, two of them; the S exchange 64 x 64 x 4 = 16,384 and the p
// exchange 8,192; barriers 24; the 1024-byte alignment of the SW128 tiles:
// 222,232 of the 232,448 a block may have, one block (256 threads, 214-224
// registers, no spill) an SM, 128 blocks on 132 SMs at m = 8192. A third
// stage would need 65,536 more. Walked tiles of 32 rows (32 KB a stage, four
// stages and a 16 KB exchange: 214,056 bytes; S of the next tile issued
// under p of this one) ran 26-55 % slower: S as an m64n32k16 tile from
// shared memory asks 1.5x the shared-memory rate, and each tile pays its
// barriers (PERF.md). At dp = 64·KB the block holds 8,192·KB·3 + 24,576 +
// 1,048 bytes.
//  * the symmetric mode splits its walk where the 64-row own blocks fill less
//    than half the card (B <= 4224 on the H100's 132 SMs: 2 ranges at 4096,
//    8 at 1000; the rule of raw_grad.cu's passes, `from_raw_splits`): one
//    block of a cluster a range of whole tiles, each leaving its accumulator
//    and rowdot partial in its drained own tile and ring; rank r then sums
//    its share of the 64 rows over the ranks' shared memory in rank order
//    and stores it (no scratch in device memory, no second launch). dX and
//    dY keep one block a 64-row tile and the whole walk.
// Every output is summed in a fixed order (no atomics), so two launches are
// equal byte for byte.
// The caller pads d to a multiple of 64 with zero columns (no dot product
// changes).

#include <cooperative_groups.h>
#include <string.h>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace clip_dplm {
namespace {

namespace cg = cooperative_groups;

// Columns [0, end) a kernel walks: the valid prefix when there is one.
__device__ inline int walk_end(int nv, int n) { return nv > 0 ? nv : n; }

constexpr int kGradRows = 64;      // own rows a block: wgmma's M
constexpr int kGradTile = 64;      // walked rows a tile: S's N, P·walk's K
constexpr int kGradThreads = 256;  // two warpgroups
constexpr int kGradStages = 2;     // walked tiles in the ring
// row_ce_grad_kernel's modes, each the index of its count in g_grad_calls
constexpr int kDx = 0, kDy = 1, kSym = 2;

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
  // the symmetric mode's split walk: each rank's accumulator (64 rows of
  // dp + 8 f32) and rowdot partial, over the own tile and the drained ring
  static constexpr size_t kSumLd = 64 * KB + 8;
  static constexpr size_t kSumRowdot = size_t(kGradRows) * kSumLd * sizeof(float);
  static_assert(kBytes <= kMaxSmem, "the block's shared memory");
  static_assert(kSumRowdot + kGradRows * sizeof(float) <= kXchg, "the reduction's shared memory");
};

// The symmetric mode's split walk: each rank leaves its accumulator and
// rowdot partial in its shared memory (the own tile and the drained ring);
// after a cluster barrier rank r sums rows [64 r / splits, 64 (r + 1) /
// splits) over the ranks in order 0, 1, ... (a fixed order: equal bytes
// launch to launch) and stores the valid ones; a second barrier keeps every
// block alive until the others have read it.
template <int KB>
__device__ __forceinline__ void split_epilogue(unsigned char* smem, const float* acc,
                                               const float* rd, float4* xchg,
                                               float* __restrict__ acc_out,
                                               float* __restrict__ rowdot, int r0, int row,
                                               int rank, int splits, int m_own) {
  using L = GradSmem<KB>;
  constexpr int kDp = 64 * KB, kHalf = (KB + 1) / 2;
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 4;
  const int blk0 = wg ? kHalf : 0, nblk = wg ? KB - kHalf : kHalf;
  float* sum = reinterpret_cast<float*>(smem);
  float* sum_rd = reinterpret_cast<float*>(smem + L::kSumRowdot);
#pragma unroll
  for (int b = 0; b < kHalf; ++b)
    if (b < nblk)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<float2*>(sum + (row - r0 + 8 * i) * L::kSumLd + (blk0 + b) * 64 +
                                     8 * n + 2 * t) =
              make_float2(acc[32 * b + 4 * n + 2 * i], acc[32 * b + 4 * n + 2 * i + 1]);
  // rowdot as the unsplit epilogue sums it, into sum_rd
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
  if (wg == 0 && t == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i) sum_rd[row - r0 + 8 * i] = v[i] + half_sum[row - r0 + 8 * i];
  __syncwarp();
  cluster_sync();
  cg::cluster_group cluster = cg::this_cluster();
  const int q0 = rank * kGradRows / splits, q1 = (rank + 1) * kGradRows / splits;
  constexpr int kQuads = kDp / 4;  // float4s a row
  for (int idx = tid; idx < (q1 - q0) * kQuads; idx += kGradThreads) {
    const int r = q0 + idx / kQuads, c4 = idx % kQuads;
    float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < splits; ++q) {
      const float4 w = *reinterpret_cast<const float4*>(cluster.map_shared_rank(sum, q) +
                                                        r * L::kSumLd + 4 * c4);
      s4.x += w.x;
      s4.y += w.y;
      s4.z += w.z;
      s4.w += w.w;
    }
    if (r0 + r < m_own) *reinterpret_cast<float4*>(acc_out + size_t(r0 + r) * kDp + 4 * c4) = s4;
  }
  if (tid < q1 - q0 && r0 + q0 + tid < m_own) {
    float s1 = 0.f;
    for (int q = 0; q < splits; ++q) s1 += cluster.map_shared_rank(sum_rd, q)[q0 + tid];
    rowdot[r0 + q0 + tid] = s1;
  }
  __syncwarp();
  cluster_sync();
}

// kDx: own = rows of x (m_own), walk = rows of y (n_walk, n_valid of them
// valid), lse_own (m_own); acc = P·y, rowdot = rowsum(p·raw).
// kDy: own = rows of y (the first m_own), walk = rows of x (n_walk),
// lse_walk (n_walk); acc = P^T·x.
// kSym: own = rows of x, walk = rows of y, lse_own (m_own) and lse_walk
// (n_walk); acc = (P_row + P_col^T)·y, rowdot = rowsum(p·raw); the walk
// split into `splits` ranges of whole tiles, one block of a cluster each
// (1: no split; dX and dY take 1).
// acc_out is (m_own, 64·KB).
template <int KB, int kMode>
__global__ void __launch_bounds__(kGradThreads, 1)
row_ce_grad_kernel(const __grid_constant__ CUtensorMap tm_own,
                   const __grid_constant__ CUtensorMap tm_walk, const float* __restrict__ scale_p,
                   const int* __restrict__ nvalid_p, const float* __restrict__ lse_own_p,
                   const float* __restrict__ lse_walk_p, float* __restrict__ acc_out,
                   float* __restrict__ rowdot, int m_own, int n_walk, int splits) {
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

  // sym: cluster blockIdx.x / splits owns 64 rows; its block of rank `rank`
  // walks range `rank` of the walked tiles
  const int rank = kMode == kSym ? blockIdx.x % splits : 0;
  const int r0 = (kMode == kSym ? blockIdx.x / splits : blockIdx.x) * kGradRows;
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128, lane = tid % kWarp;
  const int g = lane >> 2, t = lane & 3;  // the accumulator's row group and column pair
  const int row = r0 + (wt / kWarp) * 16 + g;  // own row of s[4n], s[4n + 1]; row + 8: the rest
  const int blk0 = wg ? kHalf : 0, nblk = wg ? KB - kHalf : kHalf;  // this warpgroup's blocks
  const float scale = *scale_p;
  const int nv = kMode == kDx ? max(0, min(*nvalid_p, n_walk)) : n_walk;
  // this block's walked tiles: t0 .. t0 + n_tiles - 1
  const int tiles = (walk_end(nv, n_walk) + kGradTile - 1) / kGradTile;
  int t0 = 0, n_tiles = tiles;
  if (kMode == kSym) {
    const int per = (tiles + splits - 1) / splits;
    t0 = min(tiles, rank * per);
    n_tiles = min(tiles, t0 + per) - t0;
  }

  // the block's walked tile jt into ring slot jt % kGradStages, from one
  // thread
  auto load_walk = [&](int jt) {
    const int sl = jt % kGradStages;
    mbar_expect_tx(&full[sl], unsigned(L::kTile));
    for (int b = 0; b < KB; ++b)
      tma_box_2d(sWalk + sl * (KB * kBlock) + b * kBlock, &tm_walk, b * 64,
                 (t0 + jt) * kGradTile, &full[sl]);
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
  if (kMode != kDy)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row + 8 * i < m_own) lse_own[i] = lse_own_p[row + 8 * i];
  float acc[kHalf * 32];  // 64-column block b at acc[32 b ..]
#pragma unroll
  for (int i = 0; i < kHalf * 32; ++i) acc[i] = 0.f;
  float rd[2] = {0.f, 0.f};  // rowdot of rows row, row + 8 over this thread's columns
  mbar_wait(own_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int sl = j % kGradStages, j0 = (t0 + j) * kGradTile;
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
    // dY, sym: the lse of the walked rows whose p this thread forms
    // (warpgroup h's columns, below), read while the products run
    float lw[8];
    if (kMode != kDx)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = j0 + 32 * wg + 8 * n + 2 * t + e;
          lw[2 * n + e] = c < n_walk ? lse_walk_p[c] : 0.f;
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
      // tile wholly below n_valid (dX) or n_walk (dY, sym) takes no mask.
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
                if (kMode == kDx) {
                  p = expf(raw * scale + (!masked || c < nv ? 0.f : kMaskBias) - lse_own[i]);
                  rd[i] += p * raw;
                } else if (kMode == kDy) {
                  p = expf(raw * scale - lw[2 * (n - 4 * h) + e]);
                } else {
                  const float sv = raw * scale;
                  p = exp2_ftz((sv - lse_own[i]) * kLog2e) +
                      exp2_ftz((sv - lw[2 * (n - 4 * h) + e]) * kLog2e);
                  rd[i] += p * raw;
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

  if constexpr (kMode == kSym) {
    if (splits > 1) {
      split_epilogue<KB>(smem, acc, rd, xchg, acc_out, rowdot, r0, row, rank, splits, m_own);
      return;
    }
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
  if (kMode != kDy) {
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

// Calls of row_ce_dx (0), row_ce_dy (1) and sym_infonce_grad (2) that
// launched row_ce_grad_kernel since the library was loaded.
int g_grad_calls[3] = {0, 0, 0};

// The pointers of one call: own and walk (16-byte aligned, row-major, dp
// columns), scale, n_valid (dX), the lse of the own and walked rows (as the
// mode reads them), the outputs.
struct GradArgs {
  const void *own, *walk, *scale, *nvalid, *lse_own, *lse_walk;
  void *acc, *rowdot;
};

template <int KB, int kMode>
cudaError_t launch_grad(const GradArgs& a, int m_own, int n_walk, cudaStream_t stream) {
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
  if (!tensor_map(&tm_own, a.own, 2, own_dims, strides, box) ||
      !tensor_map(&tm_walk, a.walk, 2, walk_dims, strides, box))
    return cudaErrorInvalidValue;  // e.g. a base off 16 bytes
  const size_t bytes = GradSmem<KB>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(row_ce_grad_kernel<KB, kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const auto scale = static_cast<const float*>(a.scale);
  const auto nvalid = static_cast<const int*>(a.nvalid);
  const auto lse_own = static_cast<const float*>(a.lse_own);
  const auto lse_walk = static_cast<const float*>(a.lse_walk);
  const auto acc = static_cast<float*>(a.acc), rowdot = static_cast<float*>(a.rowdot);
  const int blocks = (m_own + kGradRows - 1) / kGradRows;
  if constexpr (kMode == kSym) {
    // one cluster of `splits` blocks for each 64 own rows
    const int splits = from_raw_splits(m_own, n_walk, sm_count());
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(blocks * splits);
    cfg.blockDim = dim3(kGradThreads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, row_ce_grad_kernel<KB, kMode>, tm_own, tm_walk, scale, nvalid,
                             lse_own, lse_walk, acc, rowdot, m_own, n_walk, splits);
    if (err == cudaSuccess) err = cudaGetLastError();
  } else {
    row_ce_grad_kernel<KB, kMode><<<blocks, kGradThreads, bytes, stream>>>(
        tm_own, tm_walk, scale, nvalid, lse_own, lse_walk, acc, rowdot, m_own, n_walk, 1);
    err = cudaGetLastError();
  }
  g_grad_calls[kMode] += err == cudaSuccess;
  return err;
}

template <int kMode>
int dispatch_grad(const GradArgs& a, int m_own, int n_walk, int dp, void* stream) {
  if (m_own < 1 || n_walk < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dp) {
#define ROW_CE_CASE(KB)                                  \
  case 64 * KB:                                          \
    err = launch_grad<KB, kMode>(a, m_own, n_walk, s);   \
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
  return dispatch_grad<kDx>({x, y, scale, nvalid, lse, nullptr, py, rowdot}, m, n, dp, stream);
}

// ptx (n_rows, dp) f32 = P[:, :n_rows]^T·x with bf16 p, for the first
// n_rows rows of y; P = exp(scale·x·y^T - lse), lse (m) f32. x and y
// 16-byte aligned.
extern "C" int row_ce_dy(const void* x, const void* y, const void* scale, const void* lse,
                         void* ptx, int m, int n_rows, int dp, void* stream) {
  return dispatch_grad<kDy>({y, x, scale, nullptr, nullptr, lse, ptx, nullptr}, n_rows, m, dp,
                            stream);
}

// The symmetric InfoNCE's recompute pass: acc (m, dp) f32 = (P_row +
// P_col^T)·y with bf16 p; rowdot (m) f32 = rowsum(p·raw);
// p = exp(s - lse_row) + exp(s - lse_col), s = scale·x·y^T, lse_row (m),
// lse_col (n) f32. x and y 16-byte aligned.
extern "C" int sym_infonce_grad(const void* x, const void* y, const void* scale,
                                const void* lse_row, const void* lse_col, void* acc,
                                void* rowdot, int m, int n, int dp, void* stream) {
  return dispatch_grad<kSym>({x, y, scale, nullptr, lse_row, lse_col, acc, rowdot}, m, n, dp,
                             stream);
}

// Calls of row_ce_dx (0), row_ce_dy (1) and sym_infonce_grad (2) that
// launched the wgmma kernel row_ce_grad_kernel since the library was loaded.
extern "C" int row_ce_grad_calls(int which) {
  return which >= 0 && which < 3 ? g_grad_calls[which] : -1;
}
