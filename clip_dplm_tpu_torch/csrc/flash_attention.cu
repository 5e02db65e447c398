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
// key tiles of its query rows (dQ += ds·K); the dK/dV kernel walks the query
// tiles of its keys (dK += ds^T·Q, dV += p^T·dO), both with f32 accumulators
// kept in registers for the whole walk, rounded once and written once: no
// atomics, so runs repeat bit for bit. What bounds them on the H100: at (1,
// 8, 4096, 64), the tf_clip cell tower, dK/dV is 4 products of 2·S²·Dh·H =
// 17.2 GFLOP each (0.07 ms at 989 TFLOP/s) against ~21 MB in and out, dQ 3
// (0.05 ms): the tensor cores. The dK/dV kernel is the forward's machinery
// turned around: the keys are wgmma's M (64 a warpgroup), S^T = K·Q^T and
// dP^T = V·dO^T from K-major SW128 tiles leave p^T and ds^T in registers in
// the A-fragment layout of dV += P^T·dO and dK += dS^T·Q (dO and Q MN-major,
// the forward's P·V); K and V arrive once by TMA, Q, dO and their lse and
// delta stream through a TMA ring of 64-row tiles. The dQ kernel is the forward's loop
// with dP = dO·V^T beside S and dQ += dS·K in place of P·V: two warpgroups
// of 64 query rows, Q and dO once by TMA, K, V and the key bias through the
// ring. Both stage by elements into the same layout where TMA cannot go.

#include <string.h>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace clip_dplm {
namespace {

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

// The wgmma backward's geometry for a padded head width Dp (64 or 128): a
// block holds kRows = 64·Groups resident rows (keys for dK/dV, query rows
// for dQ), the M of its products, and streams 64-row tiles of the other side
// through a ring of kRing slots (two at Dp = 128, to keep shared memory
// under half an SM's). Shared memory: the two resident tiles (K and V; Q and
// dO), the ring's two tiles a slot (Q and dO; K and V), each slot's vectors
// (lse and delta of its 64 query rows; the bias of its 64 keys) and one
// mbarrier a slot.
template <int Dp, int Groups>
struct FlashBwd {
  static constexpr int kRows = 64 * Groups;  // resident rows of a block
  static constexpr int kThreads = 128 * Groups;
  static constexpr int kRing = Dp == 64 ? 3 : 2;
  static constexpr int kStage = 64 * Dp;  // elements of one streamed tile
  static constexpr size_t kResA = 0;
  static constexpr size_t kResB = kResA + size_t(kRows) * Dp * sizeof(bf16);
  static constexpr size_t kRingA = kResB + size_t(kRows) * Dp * sizeof(bf16);
  static constexpr size_t kRingB = kRingA + kRing * size_t(kStage) * sizeof(bf16);
  static constexpr size_t kVec = kRingB + kRing * size_t(kStage) * sizeof(bf16);
  static constexpr size_t kBar = kVec + kRing * 2 * 64 * sizeof(float);
  static constexpr size_t kBytes = kBar + kRing * sizeof(uint64_t) + 1024;  // + base alignment
};

// One block per (64 keys, head, batch row): dV = Σ over query tiles of
// p^T·dO with p in f32 (as the TPU kernel forms it: the tensor cores take p
// as bf16(p) + bf16(p - bf16(p)), two products), dK = Σ ds^T·Q. The keys are
// the M of every product: S^T = K·Q^T and dP^T = V·dO^T read both operands
// K-major from shared memory, so p^T and ds^T land in registers in the
// accumulator layout, which is the A fragment of dV += P^T·dO and dK +=
// dS^T·Q (dO and Q MN-major), the forward's P·V pattern. The key bias is per
// accumulator row (two keys a thread, read once); lse and delta are per
// column, read from the slot of their query tile. A warpgroup owns one
// 64-column block of dK and dV: at Dp = 128 two warpgroups share the keys,
// each forming all of S^T and dP^T (holding both blocks of both
// accumulators in one thread spilled). Two warpgroups of 64 keys each,
// sharing every Q/dO tile, were no faster than one; at Dp = 64 the kernel
// fits 168 registers, three blocks an SM, which gains where the grid is
// many waves deep (PERF.md).
template <int Dp>
__global__ void __launch_bounds__(Dp * 2, Dp == 64 ? 3 : 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do, const bf16* __restrict__ q,
                     const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const uint8_t* __restrict__ mask, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int S, int Sk, int Dh,
                     float scale, bool tma) {
  using G = FlashBwd<Dp, 1>;
  constexpr int R = G::kRows, T = Dp * 2, kRing = G::kRing, kSteps = Dp / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* sK = reinterpret_cast<bf16*>(smem + G::kResA);
  bf16* sV = reinterpret_cast<bf16*>(smem + G::kResB);
  bf16* sQ = reinterpret_cast<bf16*>(smem + G::kRingA);
  bf16* sDO = reinterpret_cast<bf16*>(smem + G::kRingB);
  float* sLse = reinterpret_cast<float*>(smem + G::kVec);  // [kRing][64]
  float* sDelta = sLse + kRing * 64;                        // [kRing][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::kBar);  // one a ring slot

  const int j0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const bf16* qb = q + size_t(bh) * S * Dh;
  const bf16* dob = dout + size_t(bh) * S * Dh;
  const float* lse_b = lse + size_t(bh) * S;
  const float* delta_b = delta + size_t(bh) * S;
  const uint8_t* mask_row = mask == nullptr ? nullptr : mask + size_t(b) * Sk;
  const int tid = threadIdx.x, lane = tid % kWarp, row0 = (tid % 128 / kWarp) * 16;
  const int g = lane >> 2, t = lane & 3;  // the accumulator's row group and column pair
  const int nb = tid / 128;               // the warpgroup's 64 columns of dK and dV
  const int n_tiles = (S + 63) / 64;
  const unsigned row_bytes = unsigned((Dh + 63) / 64) * 128;  // one row's TMA boxes

  // Query tile it's Q and dO into ring slot it % kRing: by TMA from one
  // thread, completing on that slot's mbarrier (K and V ride with tile 0),
  // or by element stores from all.
  auto load_q = [&](int it) {
    const int sl = it % kRing, i0 = it * 64;
    bf16* dQ = sQ + sl * G::kStage;
    bf16* dDO = sDO + sl * G::kStage;
    if (!tma) {
      stage_elems<64, Dp, T>(dQ, qb + size_t(i0) * Dh, S - i0, Dh);
      stage_elems<64, Dp, T>(dDO, dob + size_t(i0) * Dh, S - i0, Dh);
      fence_proxy_async();  // st.shared, read by wgmma
    } else if (tid == 0) {
      mbar_expect_tx(&full[sl], 2 * 64 * row_bytes + (it == 0 ? 2 * R * row_bytes : 0));
      if (it == 0) {
        tma_tile<R>(sK, &tm_k, j0, bh, Dh, &full[0]);
        tma_tile<R>(sV, &tm_v, j0, bh, Dh, &full[0]);
      }
      tma_tile<64>(dQ, &tm_q, i0, bh, Dh, &full[sl]);
      tma_tile<64>(dDO, &tm_do, i0, bh, Dh, &full[sl]);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) mbar_init(&full[i]);
    mbar_fence_init();
    const CUtensorMap* maps[4] = {&tm_q, &tm_k, &tm_v, &tm_do};
    for (int i = 0; tma && i < 4; ++i)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(maps[i]))
                   : "memory");
  }
  // the first tiles' lse and delta; zero past S, so that a padding row takes
  // p = 1 against zero dO (dV += 0) and ds = 0
  for (int i = tid; i < (kRing - 1) * 64; i += T) {
    sLse[i] = i < S ? lse_b[i] : 0.f;
    sDelta[i] = i < S ? delta_b[i] : 0.f;
  }
  if (!tma) {
    stage_elems<R, Dp, T>(sK, k + (size_t(bh) * Sk + j0) * Dh, Sk - j0, Dh);
    stage_elems<R, Dp, T>(sV, v + (size_t(bh) * Sk + j0) * Dh, Sk - j0, Dh);
    fence_proxy_async();
  }
  __syncthreads();
  for (int it = 0; it < kRing - 1 && it < n_tiles; ++it) load_q(it);
  if (!tma) __syncthreads();

  // the bias of this thread's two keys (accumulator rows g and g+8)
  float bias[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) bias[i] = state_bias(key_state(mask_row, j0 + row0 + g + 8 * i, Sk));
  // the warpgroup's block of dK and dV: one m64n64 accumulator each
  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int slot = it % kRing, ahead = it + kRing - 1;  // the tile loaded in this step
    // everyone is done with tile it-1, whose slot the load of tile `ahead`
    // takes; tile it's lse and delta are in
    if (it > 0) __syncthreads();
    // tile `ahead`'s lse and delta, loaded now, stored after the math
    const int i_ahead = ahead * 64 + tid;
    const bool row_ahead = ahead < n_tiles && tid < 64 && i_ahead < S;
    const float lse_ahead = row_ahead ? lse_b[i_ahead] : 0.f;
    const float delta_ahead = row_ahead ? delta_b[i_ahead] : 0.f;
    if (!tma && ahead < n_tiles) load_q(ahead);
    if (tma) mbar_wait(&full[slot], (it / kRing) & 1);
    const bf16* tQ = sQ + slot * G::kStage;
    const bf16* tDO = sDO + slot * G::kStage;
    const float* tL = sLse + slot * 64;
    const float* tD = sDelta + slot * 64;

    // S^T = K·Q^T and dP^T = V·dO^T: the warpgroup's 64 keys x 64 query
    // rows; all four operands K-major
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      if (kk * 16 >= Dh) continue;
      const int col = (kk % 4) * 16;  // a k16 step inside the 64-wide block kk / 4
      wgmma_m64n64k16_ss(st, gmma_desc(sK + (kk / 4) * R * 64 + col, 16, 1024),
                         gmma_desc(tQ + (kk / 4) * 64 * 64 + col, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      if (kk * 16 >= Dh) continue;
      const int col = (kk % 4) * 16;
      wgmma_m64n64k16_ss(dpt, gmma_desc(sV + (kk / 4) * R * 64 + col, 16, 1024),
                         gmma_desc(tDO + (kk / 4) * 64 * 64 + col, 16, 1024), kk > 0);
    }
    wgmma_commit();
    if (tma && ahead < n_tiles) load_q(ahead);  // issued while the products run
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // p^T = exp(s^T·scale + bias - lse), ds^T = bf16(p·(dp - delta)·scale);
    // element 4n + e of a row is query column 8n + 2t + (e & 1)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 L = *reinterpret_cast<const float2*>(tL + 8 * n + 2 * t);
      const float2 D = *reinterpret_cast<const float2*>(tD + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(fmaf(st[4 * n + e], scale, bias[e >> 1]) - (e & 1 ? L.y : L.x));
        st[4 * n + e] = p;
        dpt[4 * n + e] = p * (dpt[4 * n + e] - (e & 1 ? D.y : D.x)) * scale;
      }
    }
    // the A fragments of the kk-th 16 query rows: accumulator n-tiles 2kk,
    // 2kk+1; p as bf16(p) and bf16(p - bf16(p))
    uint32_t ph[4][4], pl[4][4], pd[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = st[8 * kk + 2 * r], c = st[8 * kk + 2 * r + 1];
        ph[kk][r] = pack_bf16(a, c);
        pl[kk][r] = pack_bf16(a - bf16r(a), c - bf16r(c));
        pd[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
      }

    // dV += P^T·dO (hi, then lo) and dK += dS^T·Q over the warpgroup's
    // columns (below Dh: Dp = 128 only for Dh > 64): A from registers, dO
    // and Q MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t d_do = gmma_desc(tDO + nb * 64 * 64 + kk * 16 * 64, 64 * 128, 1024);
      wgmma_m64n64k16_rs<1>(dv_acc, ph[kk], d_do, true);
      wgmma_m64n64k16_rs<1>(dv_acc, pl[kk], d_do, true);
      wgmma_m64n64k16_rs<1>(dk_acc, pd[kk],
                            gmma_desc(tQ + nb * 64 * 64 + kk * 16 * 64, 64 * 128, 1024), true);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // A stays put until the wait
      fence_regs(ph[kk]);
      fence_regs(pl[kk]);
      fence_regs(pd[kk]);
    }
    if (ahead < n_tiles && tid < 64) {
      sLse[(ahead % kRing) * 64 + tid] = lse_ahead;
      sDelta[(ahead % kRing) * 64 + tid] = delta_ahead;
    }
  }

  // epilogue: dK and dV rounded once to bf16 through this warp's rows and
  // its warpgroup's columns of sK and sV (once no product reads them: at Dp
  // = 128 the other warpgroup's may still), then 16-byte stores where the
  // layout allows
  if (Dp > 64) __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      if (nb * 64 + n * 8 < Dh) {
        const int at = swz<R>(r, nb * 64 + 8 * n + 2 * t);
        *reinterpret_cast<uint32_t*>(sK + at) = pack_bf16(dk_acc[4 * n + 2 * i],
                                                          dk_acc[4 * n + 2 * i + 1]);
        *reinterpret_cast<uint32_t*>(sV + at) = pack_bf16(dv_acc[4 * n + 2 * i],
                                                          dv_acc[4 * n + 2 * i + 1]);
      }
  }
  __syncwarp();
  const bool out_vec = Dh % 8 == 0 && ((reinterpret_cast<uintptr_t>(dk) |
                                        reinterpret_cast<uintptr_t>(dv)) & 15) == 0;
  const int chunks = min((Dh + 7) / 8 - 8 * nb, 8);  // the warpgroup's 8-column chunks
  for (int idx = lane; idx < 16 * chunks; idx += kWarp) {
    const int r = idx / chunks, c = 8 * nb + idx % chunks, j = j0 + row0 + r;
    if (j >= Sk) continue;
    const int at = swz<R>(row0 + r, 8 * c);
    const size_t o = (size_t(bh) * Sk + j) * Dh + 8 * c;
    if (out_vec) {
      *reinterpret_cast<uint4*>(dk + o) = *reinterpret_cast<const uint4*>(sK + at);
      *reinterpret_cast<uint4*>(dv + o) = *reinterpret_cast<const uint4*>(sV + at);
    } else {
      for (int e = 0; e < 8 && 8 * c + e < Dh; ++e) {
        dk[o + e] = sK[at + e];
        dv[o + e] = sV[at + e];
      }
    }
  }
}

// One block per (128 query rows, head, batch row), two warpgroups of 64 as
// the forward's: dQ = Σ over key tiles of ds·K, ds = bf16(p·(dp - delta)·
// scale), p = exp(s·scale + bias - lse). The query rows are the M of every
// product: S = Q·K^T and dP = dO·V^T read both operands K-major from shared
// memory, ds lands in registers in the accumulator layout, the A fragment of
// dQ += dS·K (K MN-major). lse and delta are per accumulator row (two rows
// a thread, read once); the key bias is per column, from the slot of its key
// tile. One warpgroup a block, three blocks an SM, lost 15 % at the tf_clip
// cell tower's one sequence (PERF.md).
template <int Dp>
__global__ void __launch_bounds__(FlashBwd<Dp, 2>::kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const bf16* __restrict__ q,
                    const bf16* __restrict__ k, const bf16* __restrict__ v,
                    const uint8_t* __restrict__ mask, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int H, int S, int Sk, int Dh, float scale, bool tma) {
  using G = FlashBwd<Dp, 2>;
  constexpr int R = G::kRows, T = G::kThreads, kRing = G::kRing;
  constexpr int kSteps = Dp / 16, kBlocks = Dp / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* sQ = reinterpret_cast<bf16*>(smem + G::kResA);
  bf16* sDO = reinterpret_cast<bf16*>(smem + G::kResB);
  bf16* sK = reinterpret_cast<bf16*>(smem + G::kRingA);
  bf16* sV = reinterpret_cast<bf16*>(smem + G::kRingB);
  float* sBias = reinterpret_cast<float*>(smem + G::kVec);  // [kRing][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::kBar);

  const int q0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const bf16* kb = k + size_t(bh) * Sk * Dh;
  const bf16* vb = v + size_t(bh) * Sk * Dh;
  const uint8_t* mask_row = mask == nullptr ? nullptr : mask + size_t(b) * Sk;
  const int tid = threadIdx.x, lane = tid % kWarp, row0 = (tid / kWarp) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (Sk + kKeys - 1) / kKeys;
  const int wg_row = (tid / 128) * 64;
  const unsigned row_bytes = unsigned((Dh + 63) / 64) * 128;

  // Key tile jt's K and V into ring slot jt % kRing (Q and dO ride with
  // tile 0), by TMA from one thread or by element stores from all.
  auto load_kv = [&](int jt) {
    const int sl = jt % kRing, j0 = jt * kKeys;
    bf16* dK = sK + sl * G::kStage;
    bf16* dV = sV + sl * G::kStage;
    if (!tma) {
      stage_elems<kKeys, Dp, T>(dK, kb + size_t(j0) * Dh, Sk - j0, Dh);
      stage_elems<kKeys, Dp, T>(dV, vb + size_t(j0) * Dh, Sk - j0, Dh);
      fence_proxy_async();
    } else if (tid == 0) {
      mbar_expect_tx(&full[sl], 2 * kKeys * row_bytes + (jt == 0 ? 2 * R * row_bytes : 0));
      if (jt == 0) {
        tma_tile<R>(sQ, &tm_q, q0, bh, Dh, &full[0]);
        tma_tile<R>(sDO, &tm_do, q0, bh, Dh, &full[0]);
      }
      tma_tile<kKeys>(dK, &tm_k, j0, bh, Dh, &full[sl]);
      tma_tile<kKeys>(dV, &tm_v, j0, bh, Dh, &full[sl]);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) mbar_init(&full[i]);
    mbar_fence_init();
    const CUtensorMap* maps[4] = {&tm_q, &tm_k, &tm_v, &tm_do};
    for (int i = 0; tma && i < 4; ++i)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(maps[i]))
                   : "memory");
  }
  for (int i = tid; i < (kRing - 1) * kKeys; i += T)
    sBias[i] = state_bias(key_state(mask_row, i, Sk));
  if (!tma) {
    stage_elems<R, Dp, T>(sQ, q + (size_t(bh) * S + q0) * Dh, S - q0, Dh);
    stage_elems<R, Dp, T>(sDO, dout + (size_t(bh) * S + q0) * Dh, S - q0, Dh);
    fence_proxy_async();
  }
  __syncthreads();
  for (int jt = 0; jt < kRing - 1 && jt < n_tiles; ++jt) load_kv(jt);
  if (!tma) __syncthreads();

  // lse and delta of this thread's two rows (accumulator rows g and g+8);
  // zero past S, where q and dO are zero: p = 1 against dp = 0, ds = 0
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + row0 + g + 8 * i;
    row_lse[i] = r < S ? lse[size_t(bh) * S + r] : 0.f;
    row_delta[i] = r < S ? delta[size_t(bh) * S + r] : 0.f;
  }
  float acc[kBlocks][32];
#pragma unroll
  for (int nb = 0; nb < kBlocks; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int slot = j % kRing, ahead = j + kRing - 1;
    if (j > 0) __syncthreads();
    const int state_ahead =
        ahead < n_tiles && tid < kKeys ? key_state(mask_row, ahead * kKeys + tid, Sk) : 0;
    if (!tma && ahead < n_tiles) load_kv(ahead);
    if (tma) mbar_wait(&full[slot], (j / kRing) & 1);
    const bf16* tK = sK + slot * G::kStage;
    const bf16* tV = sV + slot * G::kStage;
    const float* tB = sBias + slot * kKeys;

    // S = Q·K^T and dP = dO·V^T: the warpgroup's 64 rows x 64 keys
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      if (kk * 16 >= Dh) continue;
      const int col = (kk % 4) * 16;
      wgmma_m64n64k16_ss(s, gmma_desc(sQ + (kk / 4) * R * 64 + wg_row * 64 + col, 16, 1024),
                         gmma_desc(tK + (kk / 4) * kKeys * 64 + col, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      if (kk * 16 >= Dh) continue;
      const int col = (kk % 4) * 16;
      wgmma_m64n64k16_ss(dp, gmma_desc(sDO + (kk / 4) * R * 64 + wg_row * 64 + col, 16, 1024),
                         gmma_desc(tV + (kk / 4) * kKeys * 64 + col, 16, 1024), kk > 0);
    }
    wgmma_commit();
    if (tma && ahead < n_tiles) load_kv(ahead);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // ds = bf16(p·(dp - delta)·scale), p = exp(s·scale + bias - lse);
    // element 4n + e is row g + 8(e >> 1), key 8n + 2t + (e & 1)
    uint32_t pd[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 bb = *reinterpret_cast<const float2*>(tB + 8 * n + 2 * t);
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(fmaf(s[4 * n + e], scale, e & 1 ? bb.y : bb.x) - row_lse[e >> 1]);
        x[e] = p * (dp[4 * n + e] - row_delta[e >> 1]) * scale;
      }
      pd[n / 2][(n % 2) * 2] = pack_bf16(x[0], x[1]);
      pd[n / 2][(n % 2) * 2 + 1] = pack_bf16(x[2], x[3]);
    }

    // dQ += dS·K: A from registers, K MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < kBlocks; ++nb)
        if (nb * 64 < Dh)
          wgmma_m64n64k16_rs<1>(acc[nb], pd[kk],
                                gmma_desc(tK + nb * kKeys * 64 + kk * 16 * 64, kKeys * 128, 1024),
                                true);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < kBlocks; ++nb) fence_regs(acc[nb]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(pd[kk]);
    if (ahead < n_tiles && tid < kKeys)
      sBias[(ahead % kRing) * kKeys + tid] = state_bias(state_ahead);
  }

  // epilogue: dQ rounded once to bf16 through this warp's own rows of sQ,
  // then 16-byte stores where the layout allows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
#pragma unroll
    for (int nb = 0; nb < kBlocks; ++nb)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        if (nb * 64 + n * 8 < Dh)
          *reinterpret_cast<uint32_t*>(sQ + swz<R>(r, nb * 64 + 8 * n + 2 * t)) =
              pack_bf16(acc[nb][4 * n + 2 * i], acc[nb][4 * n + 2 * i + 1]);
  }
  __syncwarp();
  const bool out_vec = Dh % 8 == 0 && (reinterpret_cast<uintptr_t>(dq) & 15) == 0;
  const int chunks = (Dh + 7) / 8;
  for (int idx = lane; idx < 16 * chunks; idx += kWarp) {
    const int r = idx / chunks, c = idx % chunks, i = q0 + row0 + r;
    if (i >= S) continue;
    const bf16* src = sQ + swz<R>(row0 + r, 8 * c);
    bf16* dst = dq + (size_t(bh) * S + i) * Dh + 8 * c;
    if (out_vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && 8 * c + e < Dh; ++e) dst[e] = src[e];
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

// Whether q, k, v and dout go by TMA (Dh % 8 == 0, 16-byte-aligned bases:
// TMA takes no less) or by element loads inside the kernel.
static bool bwd_tma(int Dh, const void* q, const void* k, const void* v, const void* dout) {
  return Dh % 8 == 0 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) &
                         15) == 0;
}

// The backward's tensor maps: q and dout as boxes of box_q rows, k and v of
// box_k rows; false where TMA takes the tensors and an encoding failed.
static bool bwd_maps(bool tma, CUtensorMap* maps, const void* q, const void* k, const void* v,
                     const void* dout, int B, int H, int S, int Sk, int Dh, int box_q,
                     int box_k) {
  for (int i = 0; i < 4; ++i) memset(&maps[i], 0, sizeof(CUtensorMap));
  return !tma || (tensor_map(&maps[0], q, Dh, S, B * H, box_q) &&
                  tensor_map(&maps[1], k, Dh, Sk, B * H, box_k) &&
                  tensor_map(&maps[2], v, Dh, Sk, B * H, box_k) &&
                  tensor_map(&maps[3], dout, Dh, S, B * H, box_q));
}

template <int Dp>
static int launch_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* mask,
                                const void* dout, const void* lse, const void* delta, void* dk,
                                void* dv, int B, int H, int S, int Sk, int Dh, float scale,
                                void* stream) {
  using G = FlashBwd<Dp, 1>;
  const bool tma = bwd_tma(Dh, q, k, v, dout);
  CUtensorMap m[4];
  if (!bwd_maps(tma, m, q, k, v, dout, B, H, S, Sk, Dh, 64, G::kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_bwd_dkv_kernel<Dp>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(G::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sk + G::kRows - 1) / G::kRows, H, B);
  kernel<<<grid, Dp * 2, G::kBytes, static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], m[3], static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, S, Sk,
      Dh, scale, tma);
  return static_cast<int>(cudaGetLastError());
}

template <int Dp>
static int launch_flash_bwd_dq(const void* q, const void* k, const void* v, const void* mask,
                               const void* dout, const void* lse, const void* delta, void* dq,
                               int B, int H, int S, int Sk, int Dh, float scale, void* stream) {
  using G = FlashBwd<Dp, 2>;
  const bool tma = bwd_tma(Dh, q, k, v, dout);
  CUtensorMap m[4];
  if (!bwd_maps(tma, m, q, k, v, dout, B, H, S, Sk, Dh, G::kRows, kKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_bwd_dq_kernel<Dp>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(G::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + G::kRows - 1) / G::kRows, H, B);
  kernel<<<grid, G::kThreads, G::kBytes, static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], m[3], static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), H, S, Sk, Dh, scale, tma);
  return static_cast<int>(cudaGetLastError());
}

// The backward's two entries. q, k, v, mask as the forward's; dout (B, H, S,
// Dh) bf16 the cotangent of out; lse (B, H, S) f32 from the forward; delta
// (B, H, S) f32 = rowsum(dout∘out). dq (B, H, S, Dh), dk and dv (B, H, Sk,
// Dh) bf16 out. Requires 1 <= Dh <= 128, B and H <= 65535.
static bool bwd_shape_ok(int B, int H, int S, int Sk, int Dh) {
  return Dh >= 1 && Dh <= 128 && B <= 65535 && H <= 65535 && S >= 1 && Sk >= 1;
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* mask, const void* dout, const void* lse,
                                      const void* delta, void* dq, int B, int H, int S, int Sk,
                                      int Dh, float scale, void* stream) {
  if (!bwd_shape_ok(B, H, S, Sk, Dh)) return static_cast<int>(cudaErrorInvalidValue);
  auto launch = Dh <= 64 ? launch_flash_bwd_dq<64> : launch_flash_bwd_dq<128>;
  return launch(q, k, v, mask, dout, lse, delta, dq, B, H, S, Sk, Dh, scale, stream);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* mask, const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv, int B, int H, int S,
                                       int Sk, int Dh, float scale, void* stream) {
  if (!bwd_shape_ok(B, H, S, Sk, Dh)) return static_cast<int>(cudaErrorInvalidValue);
  auto launch = Dh <= 64 ? launch_flash_bwd_dkv<64> : launch_flash_bwd_dkv<128>;
  return launch(q, k, v, mask, dout, lse, delta, dk, dv, B, H, S, Sk, Dh, scale, stream);
}
