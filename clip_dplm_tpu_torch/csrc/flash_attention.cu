// Blockwise online-softmax attention with a (B, Sk) key mask, forward and
// backward, for Hopper (sm_90a).
//
// Forward: flash_fwd_kernel replaces clip_dplm_tpu/ops/flash_attention.py::
// _fwd_kernel (pallas_call in _flash_fwd, public entry flash_attention). The
// TPU kernel walks the key blocks as the innermost, sequential grid axis and
// carries m, l and the accumulator in VMEM scratch between grid steps; CUDA
// blocks run in no order, so one block per (query tile, head, batch row)
// loops over 64-key tiles itself.
//
// What bounds it on the H100: 4·S·Sk·Dh FLOP against 2·(S + 2·Sk)·Dh bytes,
// so at S = Sk = 1024 the tensor cores, not HBM, are the limit (ESM-2 650M's
// (32, 20, 1024, 64): 171.8 GFLOP, 0.17 ms at 989 TFLOP/s). K/V of one
// (b, h) is re-read by each query tile, mostly from L2. What keeps a kernel
// from that bound is everything around the products: shared-memory round
// trips of the scores, probabilities and accumulator, copies whose issue
// stalls the warps that must feed the tensor cores, and the exponentials
// (16 a cycle an SM, one a score: at Dh = 64 as many cycles as the products
// take at the full tensor rate), each of which waits on the others inside a
// warpgroup. So:
//  * the products are warpgroup wgmma (wgmma.cuh), the card's only path to
//    its full tensor rate: a warpgroup owns 64 query rows; S = Q·K^T is
//    m64n64k16 with both operands read from shared memory (K-major), and
//    O += P·V takes P from registers and V MN-major (the transpose bit);
//  * S, P, the row max m and sum l and the f32 output accumulator O never
//    leave registers: the S accumulator, rounded to bf16 pairs, is the A
//    fragment of P·V (no shuffle, no shared memory); a row's max and sum are
//    shuffles within a quad of lanes, and the rescale by alpha multiplies
//    registers, skipped by a warp whose rows all kept their max;
//  * Q, K and V arrive by TMA from one thread (cp.async.bulk.tensor, 64-column
//    boxes, completion on an mbarrier; rows past S or Sk and columns past Dh
//    arrive as zeros); per-thread 16-byte cp.async stalled the issue of the
//    very warps that feed the tensor cores (PERF.md, section 6). K and V run
//    through a ring of three tiles: the copy of tile j+2 is issued once S_j
//    is on the tensor cores, so no step waits for its tile; one barrier a
//    step frees a slot;
//  * the tiles are in the 128-byte-swizzled layout that TMA's SW128 boxes
//    write and wgmma's SW128 descriptors read (row r's 16-byte chunk c at
//    chunk c ^ (r % 8) of a 64-column block, blocks side by side, every block
//    1024-byte aligned), for K-major Q and K and MN-major V alike;
//  * a block is two warpgroups, 128 query rows, for Dp = 64 and 128, so each
//    K/V tile feeds 128 rows; Dp = 256 takes one (its O accumulator is 128
//    registers a thread).
// Dh is zero-padded to the template Dp (64, 128, 256) in shared memory only,
// never in device memory; k-steps and output columns past Dh are skipped.
// Dh % 8 != 0 or a base off 16 bytes, which TMA cannot take, stages by
// elements into the same layout.
//
// Arithmetic, as _fwd_kernel's: s = q·k^T·scale + bias, with the finite
// -1e30 bias of a masked key and -inf for padding past Sk, so padding never
// takes weight; m starts at -1e30, never -inf, so a tile of pure padding
// gives alpha = 1 and p = 0, not NaN, and a row with no real key keeps
// m = -1e30 exactly, giving p = 1 for each of its Sk keys: uniform weights.
// p = expf(s - m) in f32, the reference's natural-domain exponential (an
// exp2 domain with ex2.approx, tried first, moved the output's bf16
// roundings: PERF.md, section 6), rounded to bf16 for P·V, while l sums
// the unrounded p; out = O / max(l, 1e-30) in bf16, and the row logsumexp
// lse = m + log(max(l, 1e-30)) in f32, the residual of the backward.
//
// Backward: flash_bwd_dq_kernel replaces _bwd_dq_kernel and
// flash_bwd_dkv_kernel replaces _bwd_dkv_kernel (the two pallas_calls of
// _flash_bwd). Each recomputes p = exp(s·scale + bias - lse) tile by tile
// from the saved lse, never the (S, Sk) matrix; delta = rowsum(dO∘O) comes
// from the wrapper (a plain op, as XLA computes it outside the TPU calls).
// ds = bf16(p·(dp - delta)·scale) with dp = dO·V^T. The dQ kernel walks the
// key tiles of its 64-row query tile (dQ += ds·K); the dK/dV kernel walks the
// query tiles of its 64-key tile (dK += ds^T·Q, dV += p^T·dO), both with f32
// accumulators kept in registers for the whole walk, written once: no
// atomics. At (1, 8, 4096,
// 64), the tf_clip cell tower, the backward is 7 products of 2·S²·Dh·H = 17.2
// GFLOP, bound by operations (0.12 ms at 989 TFLOP/s); these WMMA tiles with
// synchronous staging, two blocks per SM at Dh <= 64, reach a small fraction
// of that (PERF.md).

#include <string.h>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

using namespace nvcuda;

namespace clip_dplm {
namespace {

constexpr int kBQ = 64, kBKV = 64;  // the backward's query and key tiles
constexpr int kLdS = kBKV + 4;  // padded pitches: fragment rows on distinct banks
constexpr int kLdP = kBKV + 8;

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

constexpr int kKeys = 64;  // keys a tile

// Key j's mask byte as loaded ahead (1: real, 0: masked, -1: padding past
// Sk), and its additive bias: 0, kMaskBias, -inf (common.cuh: key_bias).
__device__ __forceinline__ int key_state(const uint8_t* mask_row, int j, int n_keys) {
  return j >= n_keys ? -1 : mask_row == nullptr ? 1 : int(mask_row[j]);
}
__device__ __forceinline__ float state_bias(int state) {
  return state < 0 ? -INFINITY : state ? 0.f : kMaskBias;
}

// Rows [0, Rows) of a row-major (n_valid x Dh) bf16 slice into a swizzled
// tile by element loads and stores, for what TMA cannot take (Dh % 8 != 0, a
// base off 16 bytes); rows past n_valid and columns in [Dh, Dp) are zero.
template <int Rows, int Dp, int Threads>
__device__ __forceinline__ void stage_elems(bf16* dst, const bf16* src, int n_valid, int Dh) {
  for (int idx = threadIdx.x; idx < Rows * Dp; idx += Threads) {
    const int r = idx / Dp, d = idx % Dp;
    dst[swz<Rows>(r, d)] =
        (r < n_valid && d < Dh) ? src[size_t(r) * Dh + d] : __float2bfloat16(0.f);
  }
}

// The forward's geometry for a padded head width Dp: a warpgroup owns 64
// query rows; two warpgroups (128 rows) share each K/V tile, one for
// Dp = 256, whose O accumulator is 128 registers a thread. K, V and the key
// bias run through a ring of kRing tiles.
constexpr int kRing = 3;
template <int Dp>
struct FlashFwd {
  static constexpr int kGroups = Dp <= 128 ? 2 : 1;
  static constexpr int kRows = 64 * kGroups;  // query rows of a block
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kStage = kKeys * Dp;  // elements of one K or V stage
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + size_t(kRows) * Dp * sizeof(bf16);
  static constexpr size_t kV = kK + kRing * size_t(kStage) * sizeof(bf16);
  static constexpr size_t kBias = kV + kRing * size_t(kStage) * sizeof(bf16);
  static constexpr size_t kBar = kBias + kRing * kKeys * sizeof(float);
  static constexpr size_t kBytes = kBar + kRing * sizeof(uint64_t) + 1024;  // + base alignment
};

// tma: q, k, v go by TMA through the tensor maps (Dh % 8 == 0, 16-byte
// aligned bases); else by element loads.
template <int Dp>
__global__ void __launch_bounds__(FlashFwd<Dp>::kThreads, Dp == 64 ? 2 : 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const bf16* __restrict__ q,
                 const bf16* __restrict__ k, const bf16* __restrict__ v,
                 const uint8_t* __restrict__ mask, bf16* __restrict__ out,
                 float* __restrict__ lse, int H, int S, int Sk, int Dh, float scale, bool tma) {
  using G = FlashFwd<Dp>;
  constexpr int R = G::kRows, T = G::kThreads, kSteps = Dp / 16, kBlocks = Dp / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* sQ = reinterpret_cast<bf16*>(smem + G::kQ);
  bf16* sK = reinterpret_cast<bf16*>(smem + G::kK);
  bf16* sV = reinterpret_cast<bf16*>(smem + G::kV);
  float* sBias = reinterpret_cast<float*>(smem + G::kBias);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::kBar);  // one a ring slot

  const int q0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const bf16* kb = k + size_t(bh) * Sk * Dh;
  const bf16* vb = v + size_t(bh) * Sk * Dh;
  const uint8_t* mask_row = mask == nullptr ? nullptr : mask + size_t(b) * Sk;
  const int tid = threadIdx.x, lane = tid % kWarp, row0 = (tid / kWarp) * 16;
  const int g = lane >> 2, t = lane & 3;  // the accumulator's row group and column pair
  const int n_tiles = (Sk + kKeys - 1) / kKeys;
  const int wg_row = (tid / 128) * 64;  // the warpgroup's first row of the block
  const unsigned kv_bytes = 2 * kKeys * unsigned((Dh + 63) / 64) * 128;

  // Tile jt's K and V into ring slot jt % kRing: by TMA from one thread,
  // completing on that slot's mbarrier, or by element stores from all.
  auto load_kv = [&](int jt) {
    const int sl = jt % kRing, j0 = jt * kKeys;
    bf16* dK = sK + sl * G::kStage;
    bf16* dV = sV + sl * G::kStage;
    if (!tma) {
      stage_elems<kKeys, Dp, T>(dK, kb + size_t(j0) * Dh, Sk - j0, Dh);
      stage_elems<kKeys, Dp, T>(dV, vb + size_t(j0) * Dh, Sk - j0, Dh);
      fence_proxy_async();  // st.shared, read by wgmma
    } else if (tid == 0) {
      mbar_expect_tx(&full[sl], kv_bytes + (jt == 0 ? R * unsigned((Dh + 63) / 64) * 128 : 0));
      if (jt == 0) tma_tile<R>(sQ, &tm_q, q0, bh, Dh, &full[0]);  // Q rides with tile 0
      tma_tile<kKeys>(dK, &tm_k, j0, bh, Dh, &full[sl]);
      tma_tile<kKeys>(dV, &tm_v, j0, bh, Dh, &full[sl]);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) mbar_init(&full[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const CUtensorMap* maps[3] = {&tm_q, &tm_k, &tm_v};
    for (int i = 0; tma && i < 3; ++i)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(maps[i]))
                   : "memory");
  }
  for (int i = tid; i < (kRing - 1) * kKeys; i += T)
    sBias[i] = state_bias(key_state(mask_row, i, Sk));
  if (!tma) {
    stage_elems<R, Dp, T>(sQ, q + (size_t(bh) * S + q0) * Dh, S - q0, Dh);
    fence_proxy_async();
  }
  __syncthreads();
  for (int jt = 0; jt < kRing - 1 && jt < n_tiles; ++jt) load_kv(jt);
  if (!tma) __syncthreads();

  // O, one m64n64 accumulator per 64-wide block of d; m and l of rows g and
  // g+8 of the warp's 16, l per lane (the quad's sum is taken once, at the
  // end)
  float o[kBlocks][32];
#pragma unroll
  for (int nb = 0; nb < kBlocks; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[nb][i] = 0.f;
  float m[2] = {kMaskBias, kMaskBias}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int slot = j % kRing, ahead = j + kRing - 1;  // the tile loaded in this step
    // everyone is done with tile j-1, whose slot the load of tile `ahead`
    // takes; tile j's bias is in
    if (j > 0) __syncthreads();
    // tile `ahead`'s mask bytes, loaded now, used after the math
    const int state_ahead =
        ahead < n_tiles && tid < kKeys ? key_state(mask_row, ahead * kKeys + tid, Sk) : 0;
    if (!tma && ahead < n_tiles) load_kv(ahead);
    if (tma) mbar_wait(&full[slot], (j / kRing) & 1);
    const bf16* tK = sK + slot * G::kStage;
    const bf16* tV = sV + slot * G::kStage;
    const float* tB = sBias + slot * kKeys;

    // S = Q·K^T: the warpgroup's 64 rows x 64 keys; both operands K-major
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      if (kk * 16 >= Dh) continue;
      const int col = (kk % 4) * 16;  // a k16 step inside the 64-wide block kk / 4
      wgmma_m64n64k16_ss(s, gmma_desc(sQ + (kk / 4) * R * 64 + wg_row * 64 + col, 16, 1024),
                         gmma_desc(tK + (kk / 4) * kKeys * 64 + col, 16, 1024), kk > 0);
    }
    wgmma_commit();
    if (tma && ahead < n_tiles) load_kv(ahead);  // issued while S is on the tensor cores
    wgmma_wait<0>();
    fence_regs(s);

    // online softmax: s = S·scale + bias; a row is spread over a quad of
    // lanes
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 bb = *reinterpret_cast<const float2*>(tB + 8 * n + 2 * t);
      s[4 * n] = fmaf(s[4 * n], scale, bb.x);
      s[4 * n + 1] = fmaf(s[4 * n + 1], scale, bb.y);
      s[4 * n + 2] = fmaf(s[4 * n + 2], scale, bb.x);
      s[4 * n + 3] = fmaf(s[4 * n + 3], scale, bb.y);
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[i] = expf(m[i] - mx);
      m[i] = mx;
      l[i] *= alpha[i];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        s[4 * n + 2 * i] = expf(s[4 * n + 2 * i] - mx);
        s[4 * n + 2 * i + 1] = expf(s[4 * n + 2 * i + 1] - mx);
        l[i] += s[4 * n + 2 * i] + s[4 * n + 2 * i + 1];
      }
    }
    // O to the new max; alpha = 1 exactly where the max held, so a warp
    // whose 16 rows all kept theirs skips the multiplies
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int nb = 0; nb < kBlocks; ++nb)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          o[nb][4 * n] *= alpha[0];
          o[nb][4 * n + 1] *= alpha[0];
          o[nb][4 * n + 2] *= alpha[1];
          o[nb][4 * n + 3] *= alpha[1];
        }
    }

    // O += P·V: P from registers (the S accumulator of n-tiles 2kk, 2kk+1
    // is the A fragment of the kk-th 16 keys), V MN-major
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < kBlocks; ++nb)
        if (nb * 64 < Dh)
          wgmma_m64n64k16_rs<1>(o[nb], pa[kk],
                                gmma_desc(tV + nb * kKeys * 64 + kk * 16 * 64, kKeys * 128, 1024),
                                true);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < kBlocks; ++nb) fence_regs(o[nb]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);  // A stays put until the wait
    if (ahead < n_tiles && tid < kKeys)
      sBias[(ahead % kRing) * kKeys + tid] = state_bias(state_ahead);
  }

  // epilogue: O / l as bf16 through this warp's own rows of sQ (its
  // warpgroup's products that read them are done), then 16-byte stores
  // where the layout allows; lse = m + log(l)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    const int r = row0 + g + 8 * i;
#pragma unroll
    for (int nb = 0; nb < kBlocks; ++nb)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        if (nb * 64 + n * 8 < Dh)
          *reinterpret_cast<uint32_t*>(sQ + swz<R>(r, nb * 64 + 8 * n + 2 * t)) =
              pack_bf16(o[nb][4 * n + 2 * i] * inv, o[nb][4 * n + 2 * i + 1] * inv);
    if (t == 0 && q0 + r < S) lse[size_t(bh) * S + q0 + r] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
  __syncwarp();
  const bool out_vec = Dh % 8 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int chunks = (Dh + 7) / 8;
  for (int idx = lane; idx < 16 * chunks; idx += kWarp) {
    const int r = idx / chunks, c = idx % chunks, i = q0 + row0 + r;
    if (i >= S) continue;
    const bf16* src = sQ + swz<R>(row0 + r, 8 * c);
    bf16* dst = out + (size_t(bh) * S + i) * Dh + 8 * c;
    if (out_vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && 8 * c + e < Dh; ++e) dst[e] = src[e];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: two kernels, as the TPU's two calls (dQ; dK and dV), each a loop
// over the other side's 64-row tiles inside one block, so neither needs
// atomics and runs repeat bit for bit.
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;  // 8 warps
constexpr int kBwdWarps = kBwdThreads / kWarp;
// The f32 accumulator tiles a warp keeps in registers for the whole walk:
// dQ is (64 x Dp), 4·Dp/16 tiles of 16x16; dK and dV twice that; Dp <= 128.
constexpr int kDqFrags = 4, kDkvFrags = 8;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;

// Shared memory of a backward block. Both keep a q tile, a dO tile, a k tile
// and a v tile (bf16), the score and dP tiles (f32) and ds (bf16); the dK/dV
// block adds the probabilities split in two bf16 parts. The accumulators live
// in registers; at the end they pass through shared memory on their way out,
// over tiles no longer needed (dQ over the score and dP tiles, which are
// contiguous; dK and dV over the q, dO, k and v tiles).
struct FlashBwdSmem {
  int ld_x, ld_acc;
  size_t q, dout, k, v, s, dp, ds, phi, plo, lse, delta, bias, total;
  __host__ __device__ FlashBwdSmem(int Dp, bool dkv) {
    ld_x = Dp + 8;
    ld_acc = Dp + 4;
    const size_t tile_x = align128(size_t(kBQ) * ld_x * sizeof(bf16));
    const size_t tile_p = align128(size_t(kBQ) * kLdP * sizeof(bf16));
    size_t off = 0;
    q = off;     off += tile_x;
    dout = off;  off += tile_x;
    k = off;     off += tile_x;
    v = off;     off += tile_x;
    s = off;     off += align128(size_t(kBQ) * kLdS * sizeof(float));
    dp = off;    off += align128(size_t(kBQ) * kLdS * sizeof(float));
    ds = off;    off += tile_p;
    phi = off;   off += dkv ? tile_p : 0;
    plo = off;   off += dkv ? tile_p : 0;
    lse = off;   off += align128(kBQ * sizeof(float));
    delta = off; off += align128(kBQ * sizeof(float));
    bias = off;  off += align128(kBKV * sizeof(float));
    total = off;
  }
};

// S = Q·K^T and dP = dO·V^T over a (64 query x 64 key) tile pair, f32 into
// sS and sDP (pitch kLdS): 32 WMMA tiles over the block's 8 warps.
__device__ inline void score_and_dp_tiles(float* sS, float* sDP, const bf16* sQ, const bf16* sDO,
                                          const bf16* sK, const bf16* sV, int ldx, int Dp,
                                          int warp) {
  for (int t = warp; t < 32; t += kBwdWarps) {
    const bool is_dp = t >= 16;
    const int r = (t % 16) / 4, c = t % 4;
    const bf16* A = is_dp ? sDO : sQ;
    const bf16* Bt = is_dp ? sV : sK;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < Dp; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
      wmma::load_matrix_sync(a, A + r * 16 * ldx + kk, ldx);
      wmma::load_matrix_sync(bt, Bt + c * 16 * ldx + kk, ldx);
      wmma::mma_sync(acc, a, bt, acc);
    }
    wmma::store_matrix_sync((is_dp ? sDP : sS) + r * 16 * kLdS + c * 16, acc, kLdS,
                            wmma::mem_row_major);
  }
}

// The q-side rows of a tile: q and dO (zero past S), lse and delta (zero past
// S, so that a padding row takes p <= 1 and ds = 0).
__device__ inline void stage_q_side(bf16* sQ, bf16* sDO, float* sLse, float* sDelta, int ldx,
                                    const bf16* q, const bf16* dout, const float* lse,
                                    const float* delta, size_t bh, int i0, int S, int Dh,
                                    int Dp) {
  stage_rows(sQ, ldx, q + (bh * S + i0) * Dh, Dh, kBQ, S - i0, Dh, Dp, nullptr, nullptr, 0);
  stage_rows(sDO, ldx, dout + (bh * S + i0) * Dh, Dh, kBQ, S - i0, Dh, Dp, nullptr, nullptr, 0);
  for (int r = threadIdx.x; r < kBQ; r += blockDim.x) {
    const bool ok = i0 + r < S;
    sLse[r] = ok ? lse[bh * S + i0 + r] : 0.f;
    sDelta[r] = ok ? delta[bh * S + i0 + r] : 0.f;
  }
}

// One block per (64-row query tile, head, batch row): dQ = Σ over key tiles
// of ds·K, ds = bf16(p·(dp - delta)·scale), p = exp(s·scale + bias - lse).
__global__ void __launch_bounds__(kBwdThreads, 2)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq, int H, int S, int Sk,
                    int Dh, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dp = round_up(Dh, 16);
  const int i0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const FlashBwdSmem lay(Dp, false);
  bf16* sQ = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* sDO = reinterpret_cast<bf16*>(smem + lay.dout);
  bf16* sK = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + lay.v);
  float* sS = reinterpret_cast<float*>(smem + lay.s);
  float* sDP = reinterpret_cast<float*>(smem + lay.dp);
  bf16* sDS = reinterpret_cast<bf16*>(smem + lay.ds);
  float* sLse = reinterpret_cast<float*>(smem + lay.lse);
  float* sDelta = reinterpret_cast<float*>(smem + lay.delta);
  float* sBias = reinterpret_cast<float*>(smem + lay.bias);
  const int ldx = lay.ld_x, ldacc = lay.ld_acc;
  const int warp = threadIdx.x / kWarp;
  const int nC = Dp / 16, tiles = 4 * nC;  // warp w owns dQ tiles w, w + 8, ...
  AccFrag acc[kDqFrags];
#pragma unroll
  for (int i = 0; i < kDqFrags; ++i) wmma::fill_fragment(acc[i], 0.f);

  const size_t bh = size_t(b) * H + h;
  const uint8_t* mask_row = mask == nullptr ? nullptr : mask + size_t(b) * Sk;
  stage_q_side(sQ, sDO, sLse, sDelta, ldx, q, dout, lse, delta, bh, i0, S, Dh, Dp);

  for (int j0 = 0; j0 < Sk; j0 += kBKV) {
    __syncthreads();  // the previous tile is done with sK, sV and sDS
    stage_rows(sK, ldx, k + (bh * Sk + j0) * Dh, Dh, kBKV, Sk - j0, Dh, Dp, nullptr, nullptr, 0);
    stage_rows(sV, ldx, v + (bh * Sk + j0) * Dh, Dh, kBKV, Sk - j0, Dh, Dp, nullptr, nullptr, 0);
    for (int j = threadIdx.x; j < kBKV; j += kBwdThreads) sBias[j] = key_bias(mask_row, j0 + j, Sk);
    __syncthreads();
    score_and_dp_tiles(sS, sDP, sQ, sDO, sK, sV, ldx, Dp, warp);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kBQ * kBKV; idx += kBwdThreads) {
      const int r = idx / kBKV, c = idx % kBKV;
      const float p = expf(sS[r * kLdS + c] * scale + sBias[c] - sLse[r]);
      sDS[r * kLdP + c] = __float2bfloat16(p * (sDP[r * kLdS + c] - sDelta[r]) * scale);
    }
    __syncthreads();
    // dQ (64 x Dp) += ds (64 x 64) · K (64 x Dp)
#pragma unroll
    for (int i = 0; i < kDqFrags; ++i) {
      const int t = warp + i * kBwdWarps;
      if (t < tiles) {
        const int r = t / nC, c = t % nC;
        for (int kk = 0; kk < kBKV; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bk;
          wmma::load_matrix_sync(a, sDS + r * 16 * kLdP + kk, kLdP);
          wmma::load_matrix_sync(bk, sK + kk * ldx + c * 16, ldx);
          wmma::mma_sync(acc[i], a, bk, acc[i]);
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the score and dP tiles: dQ goes there
  float* sDQ = sS;
#pragma unroll
  for (int i = 0; i < kDqFrags; ++i) {
    const int t = warp + i * kBwdWarps;
    if (t < tiles)
      wmma::store_matrix_sync(sDQ + (t / nC) * 16 * ldacc + (t % nC) * 16, acc[i], ldacc,
                              wmma::mem_row_major);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kBQ * Dh; idx += kBwdThreads) {
    const int r = idx / Dh, d = idx % Dh;
    if (i0 + r < S) dq[(bh * S + i0 + r) * Dh + d] = __float2bfloat16(sDQ[r * ldacc + d]);
  }
}

// One block per (64-key tile, head, batch row): dV = Σ over query tiles of
// p^T·dO with p in f32 (as the TPU kernel forms it: the tensor cores take p
// as bf16(p) + bf16(p - bf16(p)), ~16 bits of it), dK = Σ ds^T·Q.
__global__ void __launch_bounds__(kBwdThreads, 2)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int S, int Sk, int Dh, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dp = round_up(Dh, 16);
  const int j0 = blockIdx.x * kBKV, h = blockIdx.y, b = blockIdx.z;
  const FlashBwdSmem lay(Dp, true);
  bf16* sQ = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* sDO = reinterpret_cast<bf16*>(smem + lay.dout);
  bf16* sK = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + lay.v);
  float* sS = reinterpret_cast<float*>(smem + lay.s);
  float* sDP = reinterpret_cast<float*>(smem + lay.dp);
  bf16* sDS = reinterpret_cast<bf16*>(smem + lay.ds);
  bf16* sPhi = reinterpret_cast<bf16*>(smem + lay.phi);
  bf16* sPlo = reinterpret_cast<bf16*>(smem + lay.plo);
  float* sLse = reinterpret_cast<float*>(smem + lay.lse);
  float* sDelta = reinterpret_cast<float*>(smem + lay.delta);
  float* sBias = reinterpret_cast<float*>(smem + lay.bias);
  const int ldx = lay.ld_x, ldacc = lay.ld_acc;
  const int warp = threadIdx.x / kWarp;

  const size_t bh = size_t(b) * H + h;
  const uint8_t* mask_row = mask == nullptr ? nullptr : mask + size_t(b) * Sk;
  stage_rows(sK, ldx, k + (bh * Sk + j0) * Dh, Dh, kBKV, Sk - j0, Dh, Dp, nullptr, nullptr, 0);
  stage_rows(sV, ldx, v + (bh * Sk + j0) * Dh, Dh, kBKV, Sk - j0, Dh, Dp, nullptr, nullptr, 0);
  for (int j = threadIdx.x; j < kBKV; j += kBwdThreads) sBias[j] = key_bias(mask_row, j0 + j, Sk);
  // warp w owns tiles w, w + 8, ... of [dK | dV], tk tiles each
  const int nC = Dp / 16, tk = 4 * nC;
  AccFrag acc[kDkvFrags];
#pragma unroll
  for (int i = 0; i < kDkvFrags; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int i0 = 0; i0 < S; i0 += kBQ) {
    __syncthreads();  // the previous tile is done with sQ, sDO and the p/ds tiles
    stage_q_side(sQ, sDO, sLse, sDelta, ldx, q, dout, lse, delta, bh, i0, S, Dh, Dp);
    __syncthreads();
    score_and_dp_tiles(sS, sDP, sQ, sDO, sK, sV, ldx, Dp, warp);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kBQ * kBKV; idx += kBwdThreads) {
      const int r = idx / kBKV, c = idx % kBKV;  // r: query, c: key
      const float p = expf(sS[r * kLdS + c] * scale + sBias[c] - sLse[r]);
      const bf16 hi = __float2bfloat16(p);
      sPhi[r * kLdP + c] = hi;
      sPlo[r * kLdP + c] = __float2bfloat16(p - __bfloat162float(hi));
      sDS[r * kLdP + c] = __float2bfloat16(p * (sDP[r * kLdS + c] - sDelta[r]) * scale);
    }
    __syncthreads();
    // dK (64 keys x Dp) += ds^T·Q; dV += p^T·dO. A = P^T: element (key i,
    // query j) is P[j][i], column-major with pitch kLdP.
#pragma unroll
    for (int i = 0; i < kDkvFrags; ++i) {
      const int t = warp + i * kBwdWarps;
      if (t < 2 * tk) {
        const bool is_dv = t >= tk;
        const int u = t % tk, r = u / nC, c = u % nC;
        const bf16* X = is_dv ? sDO : sQ;
        for (int kk = 0; kk < kBQ; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bx;
          wmma::load_matrix_sync(bx, X + kk * ldx + c * 16, ldx);
          wmma::load_matrix_sync(a, (is_dv ? sPhi : sDS) + kk * kLdP + r * 16, kLdP);
          wmma::mma_sync(acc[i], a, bx, acc[i]);
          if (is_dv) {
            wmma::load_matrix_sync(a, sPlo + kk * kLdP + r * 16, kLdP);
            wmma::mma_sync(acc[i], a, bx, acc[i]);
          }
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the q, dO, k and v tiles: dK, dV go there
  float* sDK = reinterpret_cast<float*>(smem + lay.q);
  float* sDV = sDK + kBKV * ldacc;
#pragma unroll
  for (int i = 0; i < kDkvFrags; ++i) {
    const int t = warp + i * kBwdWarps;
    if (t < 2 * tk) {
      const int u = t % tk;
      wmma::store_matrix_sync((t >= tk ? sDV : sDK) + (u / nC) * 16 * ldacc + (u % nC) * 16,
                              acc[i], ldacc, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kBKV * Dh; idx += kBwdThreads) {
    const int r = idx / Dh, d = idx % Dh;
    if (j0 + r < Sk) {
      const size_t o = (bh * Sk + j0 + r) * Dh + d;
      dk[o] = __float2bfloat16(sDK[r * ldacc + d]);
      dv[o] = __float2bfloat16(sDV[r * ldacc + d]);
    }
  }
}

}  // namespace
}  // namespace clip_dplm

using namespace clip_dplm;

template <int Dp>
static int launch_flash_fwd(const void* q, const void* k, const void* v, const void* mask,
                            void* out, void* lse, int B, int H, int S, int Sk, int Dh,
                            float scale, void* stream) {
  using G = FlashFwd<Dp>;
  // TMA takes 16-byte-aligned bases and row pitches; else the kernel stages by elements
  const bool tma = Dh % 8 == 0 && ((reinterpret_cast<uintptr_t>(q) |
                                    reinterpret_cast<uintptr_t>(k) |
                                    reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  CUtensorMap tq, tk, tv;
  memset(&tq, 0, sizeof(tq));
  memset(&tk, 0, sizeof(tk));
  memset(&tv, 0, sizeof(tv));
  if (tma && !(tensor_map(&tq, q, Dh, S, B * H, G::kRows) &&
               tensor_map(&tk, k, Dh, Sk, B * H, kKeys) &&
               tensor_map(&tv, v, Dh, Sk, B * H, kKeys)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<Dp>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(G::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + G::kRows - 1) / G::kRows, H, B);
  flash_fwd_kernel<Dp><<<grid, G::kThreads, G::kBytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(mask), static_cast<bf16*>(out),
      static_cast<float*>(lse), H, S, Sk, Dh, scale, tma);
  return static_cast<int>(cudaGetLastError());
}

// q (B, H, S, Dh), k/v (B, H, Sk, Dh), out (B, H, S, Dh) bf16; mask (B, Sk)
// uint8 or null; lse (B, H, S) f32 out. Requires 1 <= Dh <= 256.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                                   void* out, void* lse, int B, int H, int S, int Sk, int Dh,
                                   float scale, void* stream) {
  if (Dh < 1 || Dh > 256 || B > 65535 || H > 65535 || int64_t(B) * H > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);  // TMA's slice coordinate is 32-bit
  auto launch = Dh <= 64 ? launch_flash_fwd<64> : Dh <= 128 ? launch_flash_fwd<128>
                                                             : launch_flash_fwd<256>;
  return launch(q, k, v, mask, out, lse, B, H, S, Sk, Dh, scale, stream);
}

// The backward's two launchers. q, k, v, mask as the forward's; dout (B, H,
// S, Dh) bf16 the cotangent of out; lse (B, H, S) f32 from the forward;
// delta (B, H, S) f32 = rowsum(dout∘out). dq (B, H, S, Dh), dk and dv (B, H,
// Sk, Dh) bf16 out. Requires Dh <= 128.
template <typename Kernel>
static cudaError_t flash_bwd_prepare(Kernel kernel, bool dkv, int B, int H, int Dh,
                                     size_t* bytes) {
  *bytes = FlashBwdSmem(round_up(Dh, 16), dkv).total;
  if (Dh > 128 || *bytes > kMaxSmem || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*bytes));
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* mask, const void* dout, const void* lse,
                                      const void* delta, void* dq, int B, int H, int S, int Sk,
                                      int Dh, float scale, void* stream) {
  size_t bytes;
  cudaError_t err = flash_bwd_prepare(flash_bwd_dq_kernel, false, B, H, Dh, &bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_bwd_dq_kernel<<<grid, kBwdThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(dq), H,
      S, Sk, Dh, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* mask, const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv, int B, int H, int S,
                                       int Sk, int Dh, float scale, void* stream) {
  size_t bytes;
  cudaError_t err = flash_bwd_prepare(flash_bwd_dkv_kernel, true, B, H, Dh, &bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sk + kBKV - 1) / kBKV, H, B);
  flash_bwd_dkv_kernel<<<grid, kBwdThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, S, Sk, Dh, scale);
  return static_cast<int>(cudaGetLastError());
}
