// Symmetric InfoNCE over scale·a·b^T, the backward from the saved int16 raw,
// for Hopper (sm_90a): pass A (P·y and rowdot) and pass B (P^T·x) on one
// kernel template, from_raw_grad_kernel<KB, kT>, dp = 64·KB.
//
// Replaces clip_dplm_tpu/ops/fused_infonce.py: `_sym_grad_raw_kernel` and
// `_sym_grad_rawT_kernel` (the two pallas_calls in
// `_sym_grad_passes_from_raw`). The merged schedule's kernel and the
// recompute pass stay in fused_infonce.cu.
//
// What it computes (the reference's): the saving forward left raw_q, an
// (m, ldq) int16 buffer (ldq = round_up(n, 64)), with q = rint(raw ·
// RAW_QSCALE), and lse_row (m), lse_col (n). With s = q · (scale /
// RAW_QSCALE) (one multiply, as the reference folds the dequantization into
// the scale) and p = exp(s - lse_row) + exp(s - lse_col), rounded to bf16 for
// the products:
//   !kT (pass A, sym_infonce_grad_raw): own = rows of raw (m), walked = its
//     columns (n); acc_a = P·y (m, dp) f32, rowdot = sum_j p·q / RAW_QSCALE;
//   kT (pass B, sym_infonce_grad_rawT): own = columns of raw (n), walked =
//     its rows (m); acc_b = P^T·x (n, dp) f32.
// p is 0 on walked entries past n (A) or m (B), as the reference's colmask
// and rowmask make it.
//
// What bounds it on the H100: at B = 8192, d = 512 each pass is 2·B²·d =
// 69 GFLOP (0.0695 ms at 989 TFLOP/s) against the 134 MB int16 raw (0.040 ms
// at 3.35 TB/s): the tensor cores. Forming p takes two exponentials an entry,
// 134 M a pass: ~0.036 ms of the SFUs at 16 a clock an SM, so they must run
// under the products. The design is row_ce.cu's P·walk without its S
// product (the raw tile is read instead) and lse_walk.cu's producer:
//  * a block owns 64 entries (wgmma's M) and walks the other side in tiles
//    of 64. There is no own operand tile; two rings of kStages slots (3 at
//    dp = 512) hold the walked bf16 tiles (KB SW128 blocks of 64 rows x 64
//    columns, the MN-major B of P·walk) and the raw tiles (one 64 x 64 int16
//    SW128 box of the (m, ldq) buffer; TMA moves bytes, so the map is a
//    2-byte type) with the tile's 64 walked lse (a 256-byte 1-D box; zeros
//    past the end). Pass A's raw box is (own rows x walked columns), pass
//    B's (walked rows x own columns): both come straight from the one
//    buffer, with no transposed copy;
//  * p goes from the raw tile into the bf16 A-fragment registers of
//    wgmma_m64n256k16_rs (m64n64k16_rs below dp = 512): ldmatrix gives each
//    thread the int16 pairs of its fragment (pass A), and ldmatrix .trans
//    the transposed ones (pass B). An int16 pair becomes two exact floats by
//    a byte permute into the mantissa of 1.5·2^23 + 2^15 and one FADD each
//    (no conversion unit);
//  * exponentials in the exp2 domain (ex2.approx.ftz), taken as
//    2^((s - lse)·log2 e) after the reference's subtraction, so that p stays
//    within ~1e-7 of the reference's f32 value at scale 100 (one FFMA a term,
//    2^(s·log2 e - lse·log2 e), carries the lse's rounding into every entry
//    and ran no faster: PERF.md);
//  * the accumulator is split by columns between two consumer warpgroups
//    (64 x 512 f32 is 256 registers a thread in one: each holds its
//    64-column blocks, 128 registers at KB = 8), and the exponentials by K
//    halves: warpgroup h forms p of walked entries [32h, 32h + 32) of each
//    tile (its two k16 steps), publishes those A fragments in shared memory
//    and takes the other's, so each exponential is taken once in the block
//    (each warpgroup forming the whole tile, twice the exponentials and no
//    exchange, ran 12-18 % slower; PERF.md). Pass A's rowdot is summed per
//    half and the halves added once at the end;
//  * the products of tile j are issued, then p of tile j + 1 is formed into
//    a second set of fragment registers while they run; the exchange of
//    tile j + 1 follows the wait (two named barriers a tile: the other
//    warpgroup has taken tile j's half, then both halves of j + 1 are
//    published). A producer warpgroup (setmaxnreg 24; the consumers 240)
//    keeps the rings full: lane 0 of warp 8 the raw ring, whose slot is
//    freed as soon as p is formed, lane 0 of warp 9 the walked ring, freed
//    once the products retire; a full mbarrier a slot (its bytes) and an
//    empty one (one arrival a consumer warp); rows past the raw's or the
//    operand's end arrive as zeros. The own lse is read once; only a tile
//    that reaches past the walked end forms p with a mask;
//  * where the 64-entry own blocks fill less than half the card (B <= 4224
//    on the H100's 132 SMs; 64 blocks at tf_clip's B = 4096) the walk is
//    split into `splits` ranges of whole tiles (from_raw_splits: 2 at 4096,
//    8 at 1000), one block of a cluster each. Every rank leaves its
//    accumulator (and rowdot partial) in its drained rings; after a cluster
//    barrier rank r sums its share of the 64 rows over the ranks' shared
//    memory in rank order and stores it (no scratch in device memory, no
//    second launch);
//  * f32 out, valid own rows only: the outputs are (m, dp) and (n, dp) with
//    no padded rows.
// Shared memory at dp = 512 (bytes): the walked ring 3 x 65,536, the raw
// ring 3 x 8,192 and its lse 3 x 256, the p exchange 8,192, the rowdot
// halves 256, twelve barriers, 1,024 of alignment: 231,520 of 232,448; one
// block (384 threads) an SM, 128 blocks on 132 SMs at B = 8192. Every
// output is summed in a fixed order (no atomics): two launches are equal
// byte for byte.

#include <cooperative_groups.h>
#include <string.h>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace clip_dplm {
namespace {

namespace cg = cooperative_groups;

constexpr int kRawOwn = 64;       // own entries a block: wgmma's M
constexpr int kRawTile = 64;      // walked entries a tile: P·walk's K
constexpr int kRawThreads = 384;  // two consumer warpgroups and a producer warpgroup

// Shared memory of from_raw_grad_kernel<KB, *>: the walked ring (each slot
// the walked tile's KB blocks) and the raw ring (each slot one raw tile),
// every block 8,192 bytes and 1024-aligned; the raw ring's walked lse (64
// f32 a slot); the p exchange ([warpgroup][k16 step][thread] uint4); the
// rowdot halves; each ring's full and empty mbarriers.
template <int KB>
struct RawGradSmem {
  static constexpr size_t kBlock = size_t(kRawTile) * 64 * sizeof(bf16);
  static constexpr size_t kWalkSlot = KB * kBlock;
  static constexpr size_t kXchgBytes = size_t(2) * 2 * 128 * sizeof(uint4);
  static constexpr size_t kLseTile = kRawTile * sizeof(float);
  static constexpr size_t kFree = kMaxSmem - 1024 - kXchgBytes - 256 - 32 * sizeof(uint64_t);
  static constexpr size_t kPair = kWalkSlot + kBlock + kLseTile;  // a slot of each ring
  static constexpr int kStages = kFree / kPair < 8 ? int(kFree / kPair) : 8;
  static constexpr size_t kRaw = size_t(kStages) * kWalkSlot;
  static constexpr size_t kLse = kRaw + size_t(kStages) * kBlock;
  static constexpr size_t kXchg = kLse + size_t(kStages) * kLseTile;
  static constexpr size_t kHalfSum = kXchg + kXchgBytes;
  static constexpr size_t kBar = kHalfSum + 256;
  static constexpr size_t kBytes = kBar + 4 * kStages * sizeof(uint64_t) + 1024;
  // the split walk's reduction: each rank's accumulator (64 rows of dp + 8
  // f32) and rowdot partial, over the rings once they are drained
  static constexpr size_t kSumLd = 64 * KB + 8;
  static constexpr size_t kSumRowdot = size_t(kRawOwn) * kSumLd * sizeof(float);
  static_assert(kStages >= 3 && kBytes <= kMaxSmem, "the block's shared memory");
  static_assert(kSumRowdot + kRawOwn * sizeof(float) <= kXchg, "the reduction's shared memory");
};

struct RawGradArgs {
  const float* scale;     // one f32
  const float* lse_own;   // lse_row (pass A) or lse_col (pass B); the other by TMA
  float* acc;             // (n_own, 64·KB)
  float* rowdot;          // pass A: (n_own)
  int n_own, n_walk;
  int splits;             // ranges of the walk: the cluster's blocks, one a range
};

// The two int16 halves of v as exact floats: (q ^ 0x8000) placed in the low
// mantissa bits of 1.5·2^23 is 1.5·2^23 + 2^15 + q.
__device__ __forceinline__ float2 int16x2_to_float2(uint32_t v) {
  const uint32_t u = v ^ 0x80008000u;
  return make_float2(__uint_as_float(__byte_perm(u, 0x4B400000u, 0x7610)) - 12615680.f,
                     __uint_as_float(__byte_perm(u, 0x4B400000u, 0x7632)) - 12615680.f);
}

// The consumer warpgroups' exchange barrier (256 threads; the producer
// warpgroup never arrives).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 5, 256;\n" ::: "memory");
}

template <int KB, bool kT>
__global__ void __launch_bounds__(kRawThreads, 1)
from_raw_grad_kernel(const __grid_constant__ CUtensorMap tm_raw,
                     const __grid_constant__ CUtensorMap tm_walk,
                     const __grid_constant__ CUtensorMap tm_lse, const RawGradArgs a) {
  using L = RawGradSmem<KB>;
  constexpr int kDp = 64 * KB;
  constexpr int kSt = L::kStages;
  constexpr int kBlk = kRawTile * 64;     // elements of one 64 x 64 block
  constexpr int kHalf = (KB + 1) / 2;     // warpgroup 0's 64-column blocks; warpgroup 1: KB / 2
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint4* pxchg = reinterpret_cast<uint4*>(smem + L::kXchg);
  float* half_sum = reinterpret_cast<float*>(smem + L::kHalfSum);
  // walked ring: a slot's copies landed, its products retired; raw ring: a
  // slot's copy landed, its p formed
  uint64_t* full_w = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty_w = full_w + kSt;
  uint64_t* full_r = empty_w + kSt;
  uint64_t* empty_r = full_r + kSt;

  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  // cluster blockIdx.x / splits owns 64 entries; its block of rank `rank`
  // walks range `rank` of the walked tiles: tiles t0 .. t0 + count - 1
  const int rank = blockIdx.x % a.splits;
  const int o0 = blockIdx.x / a.splits * kRawOwn;
  const int tiles = (a.n_walk + kRawTile - 1) / kRawTile, per = (tiles + a.splits - 1) / a.splits;
  const int t0 = min(tiles, rank * per), count = min(tiles, t0 + per) - t0;
  auto walk_slot = [&](int j) {
    return reinterpret_cast<bf16*>(smem + (j % kSt) * L::kWalkSlot);
  };
  auto raw_slot = [&](int j) {
    return reinterpret_cast<bf16*>(smem + L::kRaw + (j % kSt) * L::kBlock);
  };
  auto lse_slot = [&](int j) {
    return reinterpret_cast<float*>(smem + L::kLse + (j % kSt) * L::kLseTile);
  };

  if (tid == 0) {
    for (int s = 0; s < kSt; ++s) {
      mbar_init(&full_w[s]);
      mbar_init(&empty_w[s], 8);  // one arrival a consumer warp
      mbar_init(&full_r[s]);
      mbar_init(&empty_r[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: lane 0 of warp 8 issues the raw
                    // tiles, lane 0 of warp 9 the walked ones
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp < 10 && lane == 0) {
      const bool raw = warp == 8;
      const CUtensorMap* tm = raw ? &tm_raw : &tm_walk;
      uint64_t* full = raw ? full_r : full_w;
      uint64_t* empty = raw ? empty_r : empty_w;
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(tm)) : "memory");
      for (int j = 0; j < count; ++j) {
        const int sl = j % kSt;
        if (j >= kSt) mbar_wait(&empty[sl], (j / kSt + 1) & 1);
        if (raw) {
          // (own rows, walked columns) for pass A, (walked rows, own columns)
          // for B; the tile's walked lse (zeros past the end) beside it
          mbar_expect_tx(&full[sl], unsigned(L::kBlock + L::kLseTile));
          const int w0 = (t0 + j) * kRawTile;
          tma_box_2d(raw_slot(j), tm, kT ? o0 : w0, kT ? w0 : o0, &full[sl]);
          tma_box_1d(lse_slot(j), &tm_lse, w0 * 2, &full[sl]);
        } else {
          mbar_expect_tx(&full[sl], unsigned(L::kWalkSlot));
          for (int b = 0; b < KB; ++b)
            tma_box_2d(walk_slot(j) + b * kBlk, tm, b * 64, (t0 + j) * kRawTile, &full[sl]);
        }
      }
    }
    if (a.splits > 1) {  // the consumers' two cluster barriers of the reduction
      __syncwarp();
      cluster_sync();
      cluster_sync();
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  // warpgroup wg holds the 64-column blocks [blk0, blk0 + nblk) of acc; this
  // thread's accumulator rows are own entries row and row + 8
  const int wg = warp / 4, wt = tid % 128, g = lane >> 2, t = lane & 3;
  const int row = o0 + (warp % 4) * 16 + g;
  const int blk0 = wg ? kHalf : 0, nblk = wg ? KB - kHalf : kHalf;
  const float c = *a.scale * kRawQInv;  // dequantization and scale in one multiply
  float lown[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) lown[i] = row + 8 * i < a.n_own ? a.lse_own[row + 8 * i] : 0.f;
  float acc[kHalf * 32];  // 64-column block b at acc[32 b ..]
#pragma unroll
  for (int i = 0; i < kHalf * 32; ++i) acc[i] = 0.f;
  float rd[2] = {0.f, 0.f};  // pass A: sum p·q of rows row, row + 8 over this thread's entries

  // The ldmatrix address of this lane in a raw tile for k16 step kk (16-bit
  // entries, SW128: row r's chunk c at c ^ (r % 8)). Pass A: row (warp % 4)·16
  // + lane % 8 + 8·((lane / 8) % 2) of the own rows, chunk 2 kk + lane / 16
  // of the walked columns. Pass B (.trans): walked row 16 kk + lane % 8 +
  // 8·(lane / 16), chunk 2·(warp % 4) + (lane / 8) % 2 of the own columns.
  auto raw_at = [&](int kk) {
    if (kT) {
      const int r = 16 * kk + (lane & 7) + 8 * (lane >> 4);
      return r * 64 + (((2 * (warp % 4) + ((lane >> 3) & 1)) ^ (lane & 7)) << 3);
    }
    const int r = (warp % 4) * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
    return r * 64 + (((2 * kk + (lane >> 4)) ^ (lane & 7)) << 3);
  };

  // Warpgroup h's half of tile j's p: the A fragments of k16 steps 2h, 2h + 1
  // (register v of step kk: own row g + 8·(v % 2), walked entries 16 kk +
  // 8·(v / 2) + 2t, +1), and pass A's rowdot. h is a constant at each call,
  // so pa stays in registers.
  auto form = [&](uint32_t(&pa)[4][4], const int h, int j) {
    const int j0 = (t0 + j) * kRawTile;
    const int16_t* raw = reinterpret_cast<const int16_t*>(raw_slot(j));
    mbar_wait(&full_r[j % kSt], (j / kSt) & 1);
    float2 lw[2][2];  // [kk - 2h][v / 2]: the walked lse of entries 2t, 2t + 1
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        lw[s][u] =
            *reinterpret_cast<const float2*>(lse_slot(j) + 16 * (2 * h + s) + 8 * u + 2 * t);
    auto exps = [&](bool masked) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int kk = 2 * h + s;
        uint32_t r[4];
        if (kT)
          ldmatrix_x4_trans(r, raw + raw_at(kk));
        else
          ldmatrix_x4(r, raw + raw_at(kk));
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = v & 1, u = v >> 1;
          const float2 q = int16x2_to_float2(r[v]);
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float qf = e ? q.y : q.x, sv = qf * c;
            const float lwe = e ? lw[s][u].y : lw[s][u].x;
            p[e] = exp2_ftz((sv - lown[i]) * kLog2e) + exp2_ftz((sv - lwe) * kLog2e);
            if (masked && j0 + 16 * kk + 8 * u + 2 * t + e >= a.n_walk) p[e] = 0.f;
            if (!kT) rd[i] += p[e] * qf;
          }
          pa[kk][v] = pack_bf16(p[0], p[1]);
        }
      }
    };
    if (j0 + kRawTile <= a.n_walk)
      exps(false);
    else
      exps(true);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_r[j % kSt]);  // this warp is done with the raw slot
  };
  auto form_own = [&](uint32_t(&pa)[4][4], int j) {
    if (wg == 0)
      form(pa, 0, j);
    else
      form(pa, 1, j);
  };
  // Both halves of a tile's fragments in both warpgroups: once the other
  // warpgroup has taken the previous tile's half, publish this one's, then
  // take the other's.
  auto exchange = [&](uint32_t(&pa)[4][4]) {
    consumers_sync();
    auto publish = [&](const int h) {
#pragma unroll
      for (int s = 0; s < 2; ++s)
        pxchg[(2 * h + s) * 128 + wt] =
            make_uint4(pa[2 * h + s][0], pa[2 * h + s][1], pa[2 * h + s][2], pa[2 * h + s][3]);
    };
    auto take = [&](const int h) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const uint4 o = pxchg[(2 * (1 - h) + s) * 128 + wt];
        pa[2 * (1 - h) + s][0] = o.x;
        pa[2 * (1 - h) + s][1] = o.y;
        pa[2 * (1 - h) + s][2] = o.z;
        pa[2 * (1 - h) + s][3] = o.w;
      }
    };
    if (wg == 0)
      publish(0);
    else
      publish(1);
    consumers_sync();
    if (wg == 0)
      take(0);
    else
      take(1);
  };
  // acc += P·walk tile j: P from registers, the walked tile MN-major
  auto mma = [&](uint32_t(&pa)[4][4], int j) {
    const bf16* tW = walk_slot(j);
    mbar_wait(&full_w[j % kSt], (j / kSt) & 1);
    wgmma_fence();
    bool wide = false;
    if constexpr (kHalf == 4) {
      if (nblk == 4) {  // the warpgroup's 256 columns in one product a k16 step
        wide = true;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n256k16_rs<1>(acc, pa[kk],
                                 gmma_desc(tW + blk0 * kBlk + kk * 16 * 64, kBlk * 2, 1024),
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
                                  gmma_desc(tW + (blk0 + b) * kBlk + kk * 16 * 64,
                                            kRawTile * 128, 1024),
                                  true);
    wgmma_commit();
  };
  // tile j's products, p of tile j + 1 formed under them, the slot released
  // once they retire, then tile j + 1's exchange
  auto step = [&](uint32_t(&cur)[4][4], uint32_t(&nxt)[4][4], int j) {
    mma(cur, j);
    if (j + 1 < count) form_own(nxt, j + 1);
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(cur[kk]);
    if (lane == 0) mbar_arrive(&empty_w[j % kSt]);
    if (j + 1 < count) exchange(nxt);
  };

  uint32_t pa0[4][4], pa1[4][4];
  if (count > 0) {
    form_own(pa0, 0);
    exchange(pa0);
  }
  for (int j = 0; j < count; j += 2) {
    step(pa0, pa1, j);
    if (j + 1 < count) step(pa1, pa0, j + 1);
  }

  // rowdot: each warpgroup's sum over its half of every tile of its range,
  // summed over the quad, then warpgroup 0's plus warpgroup 1's (through
  // shared memory; the barrier also finds both warpgroups' products retired)
  float v[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    v[i] = rd[i];
    v[i] += __shfl_xor_sync(0xffffffffu, v[i], 1);
    v[i] += __shfl_xor_sync(0xffffffffu, v[i], 2);
    if (!kT && wg == 1 && t == 0) half_sum[row - o0 + 8 * i] = v[i];
  }
  consumers_sync();
  if (!kT && wg == 0 && t == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i) v[i] += half_sum[row - o0 + 8 * i];
  if (a.splits == 1) {  // float2 stores of the valid own rows
#pragma unroll
    for (int b = 0; b < kHalf; ++b)
      if (b < nblk)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (row + 8 * i < a.n_own) {
            float* out = a.acc + size_t(row + 8 * i) * kDp + (blk0 + b) * 64 + 2 * t;
#pragma unroll
            for (int n = 0; n < 8; ++n)
              *reinterpret_cast<float2*>(out + 8 * n) =
                  make_float2(acc[32 * b + 4 * n + 2 * i], acc[32 * b + 4 * n + 2 * i + 1]);
          }
    if (!kT && wg == 0 && t == 0)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (row + 8 * i < a.n_own) a.rowdot[row + 8 * i] = v[i] * kRawQInv;
    return;
  }
  // The split walk: each rank leaves its accumulator and rowdot partial in
  // its shared memory (the drained rings); after a cluster barrier rank r
  // sums rows [64 r / splits, 64 (r + 1) / splits) over the ranks in order
  // 0, 1, ... (a fixed order: equal bytes launch to launch) and stores
  // them; a second barrier keeps every block alive until the others have
  // read it.
  float* sum = reinterpret_cast<float*>(smem);
  float* sum_rd = reinterpret_cast<float*>(smem + L::kSumRowdot);
#pragma unroll
  for (int b = 0; b < kHalf; ++b)
    if (b < nblk)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<float2*>(sum + (row - o0 + 8 * i) * L::kSumLd + (blk0 + b) * 64 +
                                     8 * n + 2 * t) =
              make_float2(acc[32 * b + 4 * n + 2 * i], acc[32 * b + 4 * n + 2 * i + 1]);
  if (!kT && wg == 0 && t == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i) sum_rd[row - o0 + 8 * i] = v[i];
  __syncwarp();
  cluster_sync();
  cg::cluster_group cluster = cg::this_cluster();
  const int r0 = rank * kRawOwn / a.splits, r1 = (rank + 1) * kRawOwn / a.splits;
  constexpr int kQuads = kDp / 4;  // float4s a row
  for (int idx = tid; idx < (r1 - r0) * kQuads; idx += 256) {
    const int r = r0 + idx / kQuads, c4 = idx % kQuads;
    float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < a.splits; ++q) {
      const float4 w = *reinterpret_cast<const float4*>(cluster.map_shared_rank(sum, q) +
                                                        r * L::kSumLd + 4 * c4);
      s4.x += w.x;
      s4.y += w.y;
      s4.z += w.z;
      s4.w += w.w;
    }
    if (o0 + r < a.n_own) *reinterpret_cast<float4*>(a.acc + size_t(o0 + r) * kDp + 4 * c4) = s4;
  }
  if (!kT && tid < r1 - r0 && o0 + r0 + tid < a.n_own) {
    float s1 = 0.f;
    for (int q = 0; q < a.splits; ++q) s1 += cluster.map_shared_rank(sum_rd, q)[r0 + tid];
    a.rowdot[o0 + r0 + tid] = s1 * kRawQInv;
  }
  __syncwarp();
  cluster_sync();
}

// Calls of sym_infonce_grad_raw (0) and sym_infonce_grad_rawT (1) that
// launched from_raw_grad_kernel since the library was loaded.
int g_from_raw_calls[2] = {0, 0};

struct FromRawCall {
  const void *raw_q, *walk, *scale, *lse_row, *lse_col;
  void *acc, *rowdot;
  int ldq, m, n;
  cudaStream_t stream;
};

template <int KB, bool kT>
cudaError_t launch_from_raw(const FromRawCall& c) {
  constexpr int kDp = 64 * KB;
  const int n_own = kT ? c.n : c.m, n_walk = kT ? c.m : c.n;
  // raw (m rows of ldq int16) as 64 x 64 boxes of a 2-byte type (TMA copies
  // bytes), and the walked operand (n_walk, dp) bf16 as 64-column boxes of
  // 64 rows
  const cuuint64_t raw_dims[2] = {cuuint64_t(c.ldq), cuuint64_t(c.m)};
  const cuuint64_t raw_strides[1] = {cuuint64_t(c.ldq) * sizeof(int16_t)};
  const cuuint64_t walk_dims[2] = {cuuint64_t(kDp), cuuint64_t(n_walk)};
  const cuuint64_t walk_strides[1] = {cuuint64_t(kDp) * sizeof(bf16)};
  const cuuint32_t box[2] = {64, 64};
  // the walked lse (n_walk f32) as 2-byte entries, 256-byte boxes, unswizzled
  const cuuint64_t lse_dims[1] = {cuuint64_t(n_walk) * 2}, lse_strides[1] = {lse_dims[0] * 2};
  const cuuint32_t lse_box[1] = {kRawTile * 2};
  CUtensorMap tm_raw, tm_walk, tm_lse;
  memset(&tm_raw, 0, sizeof(tm_raw));
  memset(&tm_walk, 0, sizeof(tm_walk));
  memset(&tm_lse, 0, sizeof(tm_lse));
  if (!tensor_map(&tm_raw, c.raw_q, 2, raw_dims, raw_strides, box) ||
      !tensor_map(&tm_walk, c.walk, 2, walk_dims, walk_strides, box) ||
      !tensor_map(&tm_lse, kT ? c.lse_row : c.lse_col, 1, lse_dims, lse_strides, lse_box,
                  CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;  // e.g. a base off 16 bytes
  const size_t bytes = RawGradSmem<KB>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(from_raw_grad_kernel<KB, kT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int splits = from_raw_splits(n_own, n_walk, sm_count());
  const RawGradArgs a{static_cast<const float*>(c.scale),
                      static_cast<const float*>(kT ? c.lse_col : c.lse_row),
                      static_cast<float*>(c.acc), static_cast<float*>(c.rowdot), n_own, n_walk,
                      splits};
  // one cluster of `splits` blocks for each 64 own entries
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((n_own + kRawOwn - 1) / kRawOwn * splits);
  cfg.blockDim = dim3(kRawThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = c.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, from_raw_grad_kernel<KB, kT>, tm_raw, tm_walk, tm_lse, a);
  if (err == cudaSuccess) err = cudaGetLastError();
  g_from_raw_calls[kT ? 1 : 0] += err == cudaSuccess;
  return err;
}

template <bool kT>
int dispatch_from_raw(const FromRawCall& c, int dp) {
  if (dp % 64 || dp < 64 || dp > 512 || c.m < 1 || c.n < 1 || c.ldq % 64 || c.ldq < c.n)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dp / 64) {
    case 1: return static_cast<int>(launch_from_raw<1, kT>(c));
    case 2: return static_cast<int>(launch_from_raw<2, kT>(c));
    case 3: return static_cast<int>(launch_from_raw<3, kT>(c));
    case 4: return static_cast<int>(launch_from_raw<4, kT>(c));
    case 5: return static_cast<int>(launch_from_raw<5, kT>(c));
    case 6: return static_cast<int>(launch_from_raw<6, kT>(c));
    case 7: return static_cast<int>(launch_from_raw<7, kT>(c));
    default: return static_cast<int>(launch_from_raw<8, kT>(c));
  }
}

}  // namespace
}  // namespace clip_dplm

using namespace clip_dplm;

// From the saved raw_q (m, ldq) int16 (ldq % 64 == 0, ldq >= n; 16-byte
// aligned), lse_row (m), lse_col (n) f32, with p = exp(s - lse_row) +
// exp(s - lse_col), s = raw_q · scale / RAW_QSCALE, bf16 p in the products.
// Pass A: acc_a (m, dp) f32 = P·y and rowdot (m) = rowsum(p·raw_q) /
// RAW_QSCALE; y (n, dp) bf16, 16-byte aligned.
extern "C" int sym_infonce_grad_raw(const void* raw_q, int ldq, const void* y, const void* scale,
                                    const void* lse_row, const void* lse_col, void* acc_a,
                                    void* rowdot, int m, int n, int dp, void* stream) {
  return dispatch_from_raw<false>(FromRawCall{raw_q, y, scale, lse_row, lse_col, acc_a, rowdot,
                                              ldq, m, n, static_cast<cudaStream_t>(stream)},
                                  dp);
}

// Pass B: acc_b (n, dp) f32 = P^T·x; x (m, dp) bf16, 16-byte aligned.
extern "C" int sym_infonce_grad_rawT(const void* raw_q, int ldq, const void* x,
                                     const void* scale, const void* lse_row, const void* lse_col,
                                     void* acc_b, int m, int n, int dp, void* stream) {
  return dispatch_from_raw<true>(FromRawCall{raw_q, x, scale, lse_row, lse_col, acc_b, nullptr,
                                             ldq, m, n, static_cast<cudaStream_t>(stream)},
                                 dp);
}

// Calls of sym_infonce_grad_raw (0) and sym_infonce_grad_rawT (1) that
// launched the wgmma kernel from_raw_grad_kernel since the library was
// loaded.
extern "C" int from_raw_grad_calls(int which) {
  return which == 0 || which == 1 ? g_from_raw_calls[which] : -1;
}
