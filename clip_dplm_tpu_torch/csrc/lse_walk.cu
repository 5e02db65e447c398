// The InfoNCE forwards' logsumexp walks over scale·x·y^T, for Hopper
// (sm_90a): the row cross-entropy's row lse with a device-side column count
// (the hard-negative cache path) and the symmetric loss's row and column lse,
// optionally saving the raw similarity as int16. One kernel template,
// lse_walk_kernel<KB, kCols, kSave, kMask>, computes all three, and one small
// kernel, lse_combine_kernel, combines their partials.
//
// Replaces clip_dplm_tpu/ops/fused_infonce.py: `_lse_kernel` (pallas_call in
// `_row_lse`), and `_sym_lse_kernel` / `_sym_lse_save_kernel` (the one
// pallas_call of `_sym_row_col_lse`, with the reference's exact combine of
// the column partials, jax.nn.logsumexp in XLA, as lse_combine_kernel).
//
//   <KB, false, false, true>  row_ce_lse: the row lse of scale·x·y^T +
//     colmask, colmask = 0 below n_valid and -1e30 from it on; n_valid is
//     read on the device (the cache's fill level lives there; the host never
//     waits for it) and the walk stops at the last valid column.
//   <KB, true, false, false>  sym_infonce_lse: the row lse and, per 64 own
//     rows and column, one column partial (the log of its sum of exp(s)).
//   <KB, true, true, false>   sym_infonce_lse_save: the same, and the raw
//     before the scale as q = rint(raw · RAW_QSCALE) in int16 (round half to
//     even, clamped). The lse of the two are the same bits.
//
// A block of 384 threads owns 128 rows of x ("own"): two consumer
// warpgroups of 64 rows each, and a producer warpgroup. It walks its share
// of the rows of y ("walked") in tiles of 64:
//  * the own rows arrive once by TMA, into the first two slots of the ring
//    (one a warpgroup), and each warpgroup reads its 64 into registers with
//    ldmatrix, as the A fragments of wgmma (16·KB registers a thread: 128 at
//    dp = 512); shared memory then holds only the ring of walked tiles. The
//    block is compiled for 168 registers a thread (one block of 384 an SM);
//    setmaxnreg moves the producer's to the consumers (24 and 240);
//  * the walked tiles arrive by TMA (tma.cuh) in SW128 K-major layout
//    through a ring of kStages slots (3 at dp = 512, up to 8 below), after
//    the own rows: one lane of the producer warpgroup issues the boxes, a
//    full mbarrier a slot (its bytes) and an empty one (one arrival a
//    consumer warp, once its products on the slot retired); rows past m or
//    n arrive as zeros;
//  * S = own·tile^T is m64n64k16 wgmma with A from registers and B from the
//    slot (wgmma.cuh): only B is read from shared memory, half the rate the
//    tensor cores could ask of it. The two warpgroups take turns to issue
//    their products (two named barriers, as FlashAttention-3's ping-pong):
//    one's products run while the other works through its scores;
//  * the scores are taken in the log2 domain, s2 = raw·scale·log2(e) + bias,
//    and each exponential is one ex2.approx.ftz (results below 2^-126 are 0):
//    the online row max and sum stay in registers (the max reduced across
//    each quad by two shuffles; the sum kept per thread and rescaled by the
//    quad's common factor, reduced once at the end), and the tile's one
//    exponential an entry, p = 2^(s2 - m_new), is reused for the column
//    partial (kCols), as the reference's `_sym_lse_impl` does: with M_w the
//    largest running row max of the warp's 16 rows and e_i = 2^(m_i - M_w)
//    (padded rows 0), sum_i p_ij e_i = sum_i 2^(s2_ij - M_w). A thread sums
//    its two rows, a reduce-scatter over the warp's eight row groups (14
//    shuffles) leaves each lane two adjacent columns, and the four warps of
//    the warpgroup meet in shared memory (double-buffered, one named barrier
//    a tile), where 64 threads combine them exactly and store the
//    warpgroup's partial of each column of the tile in log form, (M +
//    log(sum), 1): relative to the rows' largest max a column's sum can be
//    far below 1, under the combine's floor of a sum at 1e-30 (at scale 100
//    a 64-row partial can be e^-70 of its M);
//  * kSave: q is formed from the f32 accumulator before the scale (the
//    product rounded to f32 and clamped, then rounded half to even by the
//    add of 1.5·2^23, whose low 16 bits are q: no conversion unit); a pair
//    of lanes swaps one register so that each lane holds four adjacent
//    entries, and a quad stores 32 bytes of a row: 8-byte stores that fill
//    whole sectors, issued as the next tile's products run;
//  * the walk is split over column ranges (gridDim.y, chosen by the caller
//    to fill the card: at m = 8192, 64 row blocks x 2, at m = 4096, 32 x 4);
//    each range writes its row partial (max, sum), and lse_combine_kernel
//    combines the row partials over the ranges and the column partials over
//    the 64-row groups, each in a fixed order. With kMask the ranges split
//    [0, n_valid) on the device, so a partly filled cache costs nothing and
//    ranges past the valid tiles exit at once.
// No atomics: two launches are equal byte for byte.
//
// What bounds it on the H100: at B = 8192, d = 512 the symmetric forward is
// 2·8192²·512 = 69 GFLOP (0.0695 ms at 989 TFLOP/s) against 16 MB of
// operands (the int16 raw adds 134 MB, 0.040 ms at 3.35 TB/s): the tensor
// cores. Each block reads its range of y once through L2 (0.54 GB a call at
// B = 8192: 128-row blocks halve the 64-row design's copies).
// Shared memory at dp = 512 (bytes): three 65,536-byte slots; the column
// exchange 4,096 and its maxima 64; six barriers; 1,024 of alignment:
// 201,888 of 232,448, one block (384 threads) an SM.

#include <math.h>
#include <string.h>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace clip_dplm {
namespace {

constexpr int kWalkRows = 128;     // own rows a block: two consumer warpgroups
constexpr int kWalkGroup = 64;     // own rows a warpgroup: one column partial each
constexpr int kWalkTile = 64;      // walked rows a tile: S's N
constexpr int kWalkThreads = 384;  // two consumer warpgroups and a producer warpgroup
constexpr float kLn2 = 0.6931471805599453f;

// rint(v · RAW_QSCALE) in int16 for v = lo and hi (lo in the low half): the
// product rounded to f32 and clamped to int16's range, then rounded half to
// even by adding 1.5·2^23, whose float's low 16 bits are then the integer
__device__ __forceinline__ uint32_t quantize_pair(float lo, float hi) {
  constexpr float kMagic = 12582912.f;
  const float a = fminf(fmaxf(lo * kRawQScale, -32768.f), 32767.f) + kMagic;
  const float b = fminf(fmaxf(hi * kRawQScale, -32768.f), 32767.f) + kMagic;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x5410);
}

// One step of a reduce-scatter over lanes: the lanes with bit kBit set keep
// the upper kHalf entries of cs[0, 2 kHalf), the others the lower, each
// adding its partner's (lane ^ kBit); the kept sums land in cs[0, kHalf).
template <int kHalf, int kBit>
__device__ __forceinline__ void scatter_sum(float (&cs)[16], int lane) {
  const bool hi = lane & kBit;
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    const float recv = __shfl_xor_sync(0xffffffffu, hi ? cs[k] : cs[k + kHalf], kBit);
    cs[k] = (hi ? cs[k + kHalf] : cs[k]) + recv;
  }
}

// The two consumer warpgroups' turns to issue their products: warpgroup w
// waits on named barrier 3 + w (256 threads: its own 128 and the other's
// arrival), and hands the turn over by arriving on the other's.
__device__ __forceinline__ void turn_wait(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 3, 256;\n" ::: "memory");
  else
    asm volatile("bar.sync 4, 256;\n" ::: "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  if (wg == 0)
    asm volatile("bar.arrive 4, 256;\n" ::: "memory");
  else
    asm volatile("bar.arrive 3, 256;\n" ::: "memory");
}

// Shared memory of lse_walk_kernel<KB, ...>: the ring of walked tiles (each
// KB SW128 blocks of 64 rows x 64 columns), the column exchange ([warpgroup]
// [buffer][warp][64] f32 sums and [warpgroup][buffer][warp] maxima) and the
// ring's full and empty mbarriers.
template <int KB>
struct WalkSmem {
  static constexpr size_t kSlot = size_t(kWalkTile) * 64 * KB * sizeof(bf16);
  static constexpr int kStages = 200704 / kSlot < 8 ? int(200704 / kSlot) : 8;
  static constexpr size_t kCols = size_t(kStages) * kSlot;
  static constexpr size_t kColMax = kCols + 2 * 2 * 4 * 64 * sizeof(float);
  static constexpr size_t kBar = kColMax + 2 * 2 * 4 * sizeof(float);
  static constexpr size_t kBytes = kBar + 2 * kStages * sizeof(uint64_t) + 1024;
  static_assert(kStages >= 3 && kBytes <= kMaxSmem, "the block's shared memory");
};

struct WalkArgs {
  const float* scale;    // one f32
  const int* nvalid;     // kMask: one int32, the valid columns
  float* part;           // [2][nsplit][m] row partials, then (kCols) [2][groups][n]
  int16_t* raw_q;        // kSave: (m, ldq)
  int ldq, m, n;
};

template <int KB, bool kCols, bool kSave, bool kMask>
__global__ void __launch_bounds__(kWalkThreads, 1)
lse_walk_kernel(const __grid_constant__ CUtensorMap tm_own,
                const __grid_constant__ CUtensorMap tm_walk, const WalkArgs a) {
  using L = WalkSmem<KB>;
  constexpr int kDp = 64 * KB;
  constexpr int kBlock = kWalkTile * 64;  // elements of one 64-column block of a tile
  constexpr int kSt = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* xcol = reinterpret_cast<float*>(smem + L::kCols);
  float* xmax = reinterpret_cast<float*>(smem + L::kColMax);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);  // a slot's copies landed
  uint64_t* empty = full + kSt;  // a slot's products retired

  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  // this block's walked tiles: range blockIdx.y of the tiles below the end
  // of the walk (the valid prefix with kMask, read here on the device)
  const int nv = kMask ? max(0, min(*a.nvalid, a.n)) : a.n;
  const int end = nv > 0 ? nv : a.n;
  const int tiles = (end + kWalkTile - 1) / kWalkTile;
  const int per = (tiles + gridDim.y - 1) / gridDim.y;
  const int t0 = min(tiles, int(blockIdx.y) * per), count = min(tiles, t0 + per) - t0;

  if (tid == 0) {
    for (int s = 0; s < kSt; ++s) {
      mbar_init(&full[s]);
      mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: one lane issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 8 && lane == 0 && count > 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_walk))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_own))
                   : "memory");
      // load u into slot u % kSt: u = 0, 1 the own rows of warpgroup u, then
      // walked tile u - 2
      for (int u = 0; u < count + 2; ++u) {
        const int sl = u % kSt;
        if (u >= kSt) mbar_wait(&empty[sl], (u / kSt + 1) & 1);
        mbar_expect_tx(&full[sl], unsigned(L::kSlot));
        for (int b = 0; b < KB; ++b)
          tma_box_2d(ring + sl * (KB * kBlock) + b * kBlock, u < 2 ? &tm_own : &tm_walk, b * 64,
                     u < 2 ? blockIdx.x * kWalkRows + u * kWalkGroup : (t0 + u - 2) * kWalkTile,
                     &full[sl]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // warpgroup wg owns rows [64 wg, 64 wg + 64) of the block; this thread's
  // accumulator rows are row and row + 8
  const int wg = warp / 4, wt = tid % 128, g = lane >> 2, t = lane & 3;
  const int row = blockIdx.x * kWalkRows + wg * kWalkGroup + (warp % 4) * 16 + g;
  const bool ok[2] = {row < a.m, row + 8 < a.m};
  const float scale2 = *a.scale * kLog2e;

  // the A fragments of this warpgroup's own rows (mma's m16n8k16 layout,
  // wgmma.cuh), from slot wg: lane L gives the row of matrix L / 8 (rows +8
  // for matrices 1 and 3, columns +8 for 2 and 3); then every consumer warp
  // releases both own slots
  uint32_t af[4 * KB][4];
  if (count > 0) {
    const bf16* own = ring + wg * (KB * kBlock);
    const int r = (warp % 4) * 16 + (lane & 7) + 8 * ((lane >> 3) & 1), k8 = 8 * (lane >> 4);
    mbar_wait(&full[wg], 0);
#pragma unroll
    for (int kk = 0; kk < 4 * KB; ++kk) ldmatrix_x4(af[kk], own + swz<kWalkGroup>(r, 16 * kk + k8));
    if (lane == 0) {
      mbar_arrive(&empty[0]);
      mbar_arrive(&empty[1]);
    }
  }

  float mrow[2] = {-INFINITY, -INFINITY};  // running row max (log2 domain)
  float lrow[2] = {0.f, 0.f};              // this thread's share of the row sum
  // S of tile j into s (s[4n + 2i + e]: row row + 8i, column 8n + 2t + e of
  // the tile), issued in this warpgroup's turn and committed. The k16 step
  // (b, c) reads the tile 16·b·kBlock/64 + 2c descriptor units (of 16
  // bytes) on from its start: one add each
  auto mma = [&](float(&s)[32], int j) {
    const int u = j + 2;  // its load's place in the ring's order
    const uint64_t d0 = gmma_desc(ring + (u % kSt) * (KB * kBlock), 16, 1024);
    mbar_wait(&full[u % kSt], (u / kSt) & 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    turn_wait(wg);
    wgmma_fence();
#pragma unroll
    for (int b = 0; b < KB; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c)  // a k16 step: 32 bytes along the 128-byte row
        wgmma_m64n64k16_rs<0>(s, af[4 * b + c], d0 + uint64_t(b * (kBlock / 8) + 2 * c),
                              b > 0 || c > 0);
    wgmma_commit();
    turn_pass(wg);
  };
  // the rest of tile j, from its retired S
  auto epilogue = [&](float(&s)[32], int j) {
    const int j0 = (t0 + j) * kWalkTile;
    if (kSave) {
      // q of rows row, row + 8: lanes t, t^1 swap one register of each pair of
      // n-tiles, so that each holds four adjacent entries; a quad then
      // stores 32 bytes of a row (one sector) a k
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t v[8];
#pragma unroll
        for (int n = 0; n < 8; ++n) v[n] = quantize_pair(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]);
        int16_t* out = a.raw_q + size_t(row + 8 * i) * a.ldq + j0 + ((t & 1) ? 2 * t + 6 : 2 * t);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t recv = __shfl_xor_sync(0xffffffffu, (t & 1) ? v[2 * k] : v[2 * k + 1], 1);
          if (ok[i])
            *reinterpret_cast<uint2*>(out + 16 * k) =
                (t & 1) ? make_uint2(recv, v[2 * k + 1]) : make_uint2(v[2 * k], recv);
        }
      }
    }

    // scores in the log2 domain: padded columns -inf (the symmetric loss),
    // masked ones -1e30 (the reference's colmask, which covers the padding)
    float bias[8][2];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j0 + 8 * n + 2 * t + e;
        bias[n][e] = kMask ? (c < nv ? 0.f : kMaskBias * kLog2e) : (c < a.n ? 0.f : -INFINITY);
      }
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = s[4 * n + 2 * i + e];
          v = fmaf(v, scale2, bias[n][e]);
          mt[i] = fmaxf(mt[i], v);
        }
    float mn[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      mn[i] = fmaxf(mrow[i], mt[i]);
    }
    // the one exponential an entry
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = s[4 * n + 2 * i + e];
          v = exp2_ftz(v - mn[i]);
          ls[i] += v;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lrow[i] = lrow[i] * exp2_ftz(mrow[i] - mn[i]) + ls[i];
      mrow[i] = mn[i];
    }

    if (kCols) {
      // the warp's partial of each column, relative to its largest row max
      float mw = fmaxf(ok[0] ? mn[0] : -INFINITY, ok[1] ? mn[1] : -INFINITY);
      mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, 4));
      mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, 8));
      mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, 16));
      const float e0 = ok[0] ? exp2_ftz(mn[0] - mw) : 0.f, e1 = ok[1] ? exp2_ftz(mn[1] - mw) : 0.f;
      float cs[16];  // cs[2n + e]: column 8n + 2t + e
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) cs[2 * n + e] = s[4 * n + e] * e0 + s[4 * n + 2 + e] * e1;
      // reduce-scatter over the row groups g (lane bits 4, 3, 2): lane (g, t)
      // ends with cs[2g], cs[2g + 1], columns 2·lane and 2·lane + 1
      scatter_sum<8, 16>(cs, lane);
      scatter_sum<4, 8>(cs, lane);
      scatter_sum<2, 4>(cs, lane);
      const int buf = j & 1, wq = warp % 4;
      float* xc = xcol + (wg * 2 + buf) * 4 * 64;
      float* xm = xmax + (wg * 2 + buf) * 4;
      *reinterpret_cast<float2*>(xc + wq * 64 + 2 * lane) = make_float2(cs[0], cs[1]);
      if (lane == 0) xm[wq] = mw;
      wg_sync(wg);
      // the warpgroup's partial of column j0 + wt, the four warps' combined
      // in order (the buffer is rewritten two tiles on, after the next barrier)
      const int grp = blockIdx.x * 2 + wg, groups = (a.m + kWalkGroup - 1) / kWalkGroup;
      if (wt < 64 && grp < groups && j0 + wt < a.n) {
        float M = fmaxf(fmaxf(xm[0], xm[1]), fmaxf(xm[2], xm[3]));
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w)
          if (xm[w] > -INFINITY) sum += xc[w * 64 + wt] * exp2_ftz(xm[w] - M);
        // stored as (M + log(sum), 1), or (-inf, 0) for none: a sum far below
        // 1 (M is the rows' max, not this column's) must not meet the
        // combine's floor of a sum at 1e-30
        float* cmax = a.part + 2 * size_t(gridDim.y) * a.m;
        cmax[size_t(grp) * a.n + j0 + wt] = sum > 0.f ? (M + log2f(sum)) * kLn2 : -INFINITY;
        cmax[size_t(groups + grp) * a.n + j0 + wt] = sum > 0.f ? 1.f : 0.f;
      }
    }
  };

  if (wg == 1 && count > 0) turn_pass(1);  // warpgroup 0 goes first
  for (int j = 0; j < count; ++j) {
    float s[32];
    mma(s, j);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(&empty[(j + 2) % kSt]);  // this warp is done with the slot
    epilogue(s, j);
  }

  // this range's row partial: natural-log max and the quad's sum
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = lrow[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (t == 0 && ok[i]) {
      a.part[size_t(blockIdx.y) * a.m + row + 8 * i] = mrow[i] * kLn2;
      a.part[size_t(gridDim.y + blockIdx.y) * a.m + row + 8 * i] = l;
    }
  }
}

// row_lse[i] (i < m) = logsumexp over the nsplit row partials of i, and
// col_lse[j] (j < n) over the `groups` column partials of j, each partial
// (max, sum) taken as max + log(max(sum, 1e-30)) (the reference's combine;
// all -inf gives -inf). A block takes 32 entries, one a lane; warp w folds
// partials w, w + 8, ... of its entry into a running (max, sum) in that
// order, and the eight warps' are combined in order: a fixed order, no
// atomics, and 8 warps of loads in flight for each entry's chain.
constexpr int kCombineWarps = 8;
__global__ void __launch_bounds__(kCombineWarps * kWarp)
lse_combine_kernel(const float* __restrict__ part, int nsplit, int m, int groups, int n,
                   float* __restrict__ row_lse, float* __restrict__ col_lse) {
  __shared__ float top_s[kCombineWarps][kWarp], acc_s[kCombineWarps][kWarp];
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  const int i = blockIdx.x * kWarp + lane;
  const bool is_row = i < m;
  float top = -INFINITY, acc = 0.f;
  if (i < m + n) {
    const int parts = is_row ? nsplit : groups;
    const size_t stride = is_row ? m : n;
    const float* mx = is_row ? part + i : part + 2 * size_t(nsplit) * m + (i - m);
    const float* sm = mx + size_t(parts) * stride;
    for (int k = w; k < parts; k += kCombineWarps) {
      const float lp = mx[k * stride] + logf(fmaxf(sm[k * stride], 1e-30f));
      if (lp > top) {
        acc = acc * expf(top - lp) + 1.f;
        top = lp;
      } else if (lp > -INFINITY) {
        acc += expf(lp - top);
      }
    }
  }
  top_s[w][lane] = top;
  acc_s[w][lane] = acc;
  __syncthreads();
  if (w > 0 || i >= m + n) return;
  float T = -INFINITY, A = 0.f;
  for (int v = 0; v < kCombineWarps; ++v) T = fmaxf(T, top_s[v][lane]);
  if (T > -INFINITY)
    for (int v = 0; v < kCombineWarps; ++v)
      if (top_s[v][lane] > -INFINITY) A += acc_s[v][lane] * expf(top_s[v][lane] - T);
  const float out = T > -INFINITY ? T + logf(A) : -INFINITY;
  if (is_row)
    row_lse[i] = out;
  else
    col_lse[i - m] = out;
}

// Calls of row_ce_lse (0), sym_infonce_lse (1) and sym_infonce_lse_save (2)
// that launched lse_walk_kernel since the library was loaded.
int g_walk_calls[3] = {0, 0, 0};

struct WalkCall {
  const void *x, *y, *scale, *nvalid;
  void *part, *raw_q;
  int ldq, m, n, dp, nsplit;
  cudaStream_t stream;
};

template <int KB, bool kCols, bool kSave, bool kMask>
cudaError_t launch_walk(const WalkCall& c) {
  constexpr int kDp = 64 * KB;
  // x (m, dp) and y (n, dp) row-major, as boxes of 64 columns by 64 rows
  const cuuint64_t own_dims[2] = {cuuint64_t(kDp), cuuint64_t(c.m)};
  const cuuint64_t walk_dims[2] = {cuuint64_t(kDp), cuuint64_t(c.n)};
  const cuuint64_t strides[1] = {cuuint64_t(kDp) * sizeof(bf16)};
  const cuuint32_t box[2] = {64, 64};
  CUtensorMap tm_own, tm_walk;
  memset(&tm_own, 0, sizeof(tm_own));
  memset(&tm_walk, 0, sizeof(tm_walk));
  if (!tensor_map(&tm_own, c.x, 2, own_dims, strides, box) ||
      !tensor_map(&tm_walk, c.y, 2, walk_dims, strides, box))
    return cudaErrorInvalidValue;  // e.g. a base off 16 bytes
  const size_t bytes = WalkSmem<KB>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(lse_walk_kernel<KB, kCols, kSave, kMask>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const WalkArgs a{static_cast<const float*>(c.scale),
                   static_cast<const int*>(c.nvalid), static_cast<float*>(c.part),
                   static_cast<int16_t*>(c.raw_q), c.ldq, c.m, c.n};
  const dim3 grid((c.m + kWalkRows - 1) / kWalkRows, c.nsplit);
  lse_walk_kernel<KB, kCols, kSave, kMask><<<grid, kWalkThreads, bytes, c.stream>>>(tm_own,
                                                                                      tm_walk, a);
  err = cudaGetLastError();
  g_walk_calls[kMask ? 0 : (kSave ? 2 : 1)] += err == cudaSuccess;
  return err;
}

template <bool kCols, bool kSave, bool kMask>
int dispatch_walk(const WalkCall& c) {
  if (c.dp % 64 || c.dp < 64 || c.dp > 512 || c.m < 1 || c.n < 1 || c.nsplit < 1 ||
      c.nsplit > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (c.dp / 64) {
    case 1: return static_cast<int>(launch_walk<1, kCols, kSave, kMask>(c));
    case 2: return static_cast<int>(launch_walk<2, kCols, kSave, kMask>(c));
    case 3: return static_cast<int>(launch_walk<3, kCols, kSave, kMask>(c));
    case 4: return static_cast<int>(launch_walk<4, kCols, kSave, kMask>(c));
    case 5: return static_cast<int>(launch_walk<5, kCols, kSave, kMask>(c));
    case 6: return static_cast<int>(launch_walk<6, kCols, kSave, kMask>(c));
    case 7: return static_cast<int>(launch_walk<7, kCols, kSave, kMask>(c));
    default: return static_cast<int>(launch_walk<8, kCols, kSave, kMask>(c));
  }
}

}  // namespace
}  // namespace clip_dplm

using namespace clip_dplm;

// x (m, dp), y (n, dp) bf16, 16-byte aligned, dp % 64 == 0 and dp <= 512;
// scale: one f32 and n_valid: one int32 on the device. part: f32 scratch of
// 2·nsplit·m (the row partials of nsplit column ranges), for lse_combine
// with groups = 0.
extern "C" int row_ce_lse(const void* x, const void* y, const void* scale, const void* nvalid,
                          void* part, int m, int n, int dp, int nsplit, void* stream) {
  return dispatch_walk<false, false, true>(WalkCall{x, y, scale, nvalid, part, nullptr, 0, m, n,
                                                    dp, nsplit,
                                                    static_cast<cudaStream_t>(stream)});
}

// As row_ce_lse without a column count, and the column partials: part is
// 2·nsplit·m + 2·groups·n f32, groups = ceil(m / 64), for lse_combine.
extern "C" int sym_infonce_lse(const void* x, const void* y, const void* scale, void* part, int m,
                               int n, int dp, int nsplit, void* stream) {
  return dispatch_walk<true, false, false>(WalkCall{x, y, scale, nullptr, part, nullptr, 0, m, n,
                                                    dp, nsplit,
                                                    static_cast<cudaStream_t>(stream)});
}

// sym_infonce_lse, and raw_q (m, ldq) int16 = rint(x·y^T · RAW_QSCALE) over
// whole 64-column tiles (ldq % 64 == 0, ldq >= n; zero past n); the same
// partials bit for bit.
extern "C" int sym_infonce_lse_save(const void* x, const void* y, const void* scale, void* part,
                                    void* raw_q, int ldq, int m, int n, int dp, int nsplit,
                                    void* stream) {
  if (ldq % 64 || ldq < n) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_walk<true, true, false>(WalkCall{x, y, scale, nullptr, part, raw_q, ldq, m, n,
                                                   dp, nsplit,
                                                   static_cast<cudaStream_t>(stream)});
}

// row_lse (m) and, for n > 0, col_lse (n) f32 from the partials the walk
// wrote into part (nsplit row ranges; groups 64-row column partials).
extern "C" int lse_combine(const void* part, int nsplit, int m, int groups, int n, void* row_lse,
                           void* col_lse, void* stream) {
  if (m < 1 || nsplit < 1 || n < 0 || (n > 0 && groups < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  lse_combine_kernel<<<(m + n + kWarp - 1) / kWarp, kCombineWarps * kWarp, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), nsplit, m, groups, n, static_cast<float*>(row_lse),
      static_cast<float*>(col_lse));
  return static_cast<int>(cudaGetLastError());
}

// Calls of row_ce_lse (0), sym_infonce_lse (1) and sym_infonce_lse_save (2)
// that launched the wgmma walk lse_walk_kernel since the library was loaded.
extern "C" int lse_walk_calls(int which) {
  return which >= 0 && which < 3 ? g_walk_calls[which] : -1;
}
