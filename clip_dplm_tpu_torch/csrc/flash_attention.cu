// Blockwise online-softmax attention with a (B, Sk) key mask, forward and
// backward, for Hopper (sm_90a).
//
// Replaces clip_dplm_tpu/ops/flash_attention.py::_fwd_kernel (pallas_call in
// _flash_fwd, public entry flash_attention). The TPU kernel walks the key
// blocks as the innermost, sequential grid axis and carries m, l and the
// accumulator in VMEM scratch between grid steps; CUDA blocks run in no
// order, so here one block per (64-row query tile, head, batch row) loops
// over 64-key tiles itself and keeps m, l and the f32 accumulator in shared
// memory for the whole walk.
//
// Per key tile: S = q·k^T on the tensor cores (WMMA 16x16x16 bf16, f32
// accumulation), s = S·scale + bias with the finite -1e30 bias of a masked
// key (and -inf for padding past Sk, which never takes weight), m_new =
// max(m, rowmax s), alpha = exp(m - m_new), p = exp(s - m_new) rounded to bf16
// for p·V, l = l·alpha + rowsum p, acc = acc·alpha + p·V. The row ends as
// acc / max(l, 1e-30). The scale comes from the unpadded Dh; Dh is padded to
// a multiple of 16 in shared memory only, never in device memory.
//
// Bounds on the H100: each block reads its q tile once and every k/v tile of
// its (b, h) once, 2·64·Dh bytes per key tile for 4·64·64·Dh FLOP, i.e. 128
// FLOP per byte at any Dh: below the card's ~295 FLOP/byte ridge, so the
// loads bound it (K/V of one (b, h) is re-read by each of the S/64 query
// tiles, mostly from L2), and so does their latency: a tile is staged with
// 16-byte loads (element loads when Dh % 8 != 0) into bank-padded shared
// memory before any math starts. cp.async/TMA double buffering and wgmma are
// later work. The forward also writes the row logsumexp for the backward,
// lse = m + log(max(l, 1e-30)) in f32, as _fwd_kernel does.
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

#include "common.cuh"

using namespace nvcuda;

namespace clip_dplm {
namespace {

constexpr int kThreads = 128;  // 4 warps; warp w owns query rows 16w..16w+15
constexpr int kBQ = 64, kBKV = 64;
constexpr int kLdS = kBKV + 4;  // padded pitches: fragment rows on distinct banks
constexpr int kLdP = kBKV + 8;

struct FlashSmem {
  int ld_qkv, ld_o;
  size_t q, k, v, s, p, o, m, l, bias, total;
  __host__ __device__ explicit FlashSmem(int Dp) {
    ld_qkv = Dp + 8;
    ld_o = Dp + 4;
    size_t off = 0;
    q = off;    off += align128(size_t(kBQ) * ld_qkv * sizeof(bf16));
    k = off;    off += align128(size_t(kBKV) * ld_qkv * sizeof(bf16));
    v = off;    off += align128(size_t(kBKV) * ld_qkv * sizeof(bf16));
    s = off;    off += align128(size_t(kBQ) * kLdS * sizeof(float));
    p = off;    off += align128(size_t(kBQ) * kLdP * sizeof(bf16));
    o = off;    off += align128(size_t(kBQ) * ld_o * sizeof(float));
    m = off;    off += align128(kBQ * sizeof(float));
    l = off;    off += align128(kBQ * sizeof(float));
    bias = off; off += align128(kBKV * sizeof(float));
    total = off;
  }
};

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                 bf16* __restrict__ out, float* __restrict__ lse, int H, int S, int Sk, int Dh,
                 float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dp = round_up(Dh, 16);
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const FlashSmem lay(Dp);
  bf16* sQ = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* sK = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + lay.v);
  float* sS = reinterpret_cast<float*>(smem + lay.s);
  bf16* sP = reinterpret_cast<bf16*>(smem + lay.p);
  float* sO = reinterpret_cast<float*>(smem + lay.o);
  float* sM = reinterpret_cast<float*>(smem + lay.m);
  float* sL = reinterpret_cast<float*>(smem + lay.l);
  float* sBias = reinterpret_cast<float*>(smem + lay.bias);
  const int ldq = lay.ld_qkv, ldo = lay.ld_o;

  const size_t bh = size_t(b) * H + h;
  const bf16* kb = k + bh * Sk * Dh;
  const bf16* vb = v + bh * Sk * Dh;
  const uint8_t* mask_row = mask == nullptr ? nullptr : mask + size_t(b) * Sk;

  stage_rows(sQ, ldq, q + (bh * S + q0) * Dh, Dh, kBQ, S - q0, Dh, Dp, nullptr, nullptr, 0);
  for (int idx = threadIdx.x; idx < kBQ * ldo; idx += kThreads) sO[idx] = 0.f;
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    sM[r] = kMaskBias;
    sL[r] = 0.f;
  }

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int j0 = 0; j0 < Sk; j0 += kBKV) {
    stage_rows(sK, ldq, kb + size_t(j0) * Dh, Dh, kBKV, Sk - j0, Dh, Dp, nullptr, nullptr, 0);
    stage_rows(sV, ldq, vb + size_t(j0) * Dh, Dh, kBKV, Sk - j0, Dh, Dp, nullptr, nullptr, 0);
    for (int j = threadIdx.x; j < kBKV; j += kThreads) sBias[j] = key_bias(mask_row, j0 + j, Sk);
    __syncthreads();

    // scores of this warp's 16 rows against the 64 keys of the tile
    for (int c = 0; c < kBKV / 16; ++c) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < Dp; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, sQ + warp * 16 * ldq + kk, ldq);
        wmma::load_matrix_sync(bt, sK + c * 16 * ldq + kk, ldq);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(sS + warp * 16 * kLdS + c * 16, acc, kLdS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over the warp's rows: two keys per lane
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const float s0 = sS[r * kLdS + lane] * scale + sBias[lane];
      const float s1 = sS[r * kLdS + lane + kWarp] * scale + sBias[lane + kWarp];
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m_prev - m_new);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      sP[r * kLdP + lane] = __float2bfloat16(p0);
      sP[r * kLdP + lane + kWarp] = __float2bfloat16(p1);
      const float psum = warp_sum(p0 + p1);
      for (int d = lane; d < Dp; d += kWarp) sO[r * ldo + d] *= alpha;
      __syncwarp();
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + psum;
      }
    }
    __syncwarp();

    // acc += p · V for the warp's rows
    for (int c = 0; c < Dp / 16; ++c) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + warp * 16 * ldo + c * 16, ldo, wmma::mem_row_major);
      for (int kk = 0; kk < kBKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, sP + warp * 16 * kLdP + kk, kLdP);
        wmma::load_matrix_sync(bv, sV + kk * ldq + c * 16, ldq);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(sO + warp * 16 * ldo + c * 16, acc, ldo, wmma::mem_row_major);
    }
    __syncthreads();  // sK/sV/sBias are overwritten by the next tile
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < kBQ * Dh; idx += kThreads) {
    const int r = idx / Dh, d = idx % Dh, i = q0 + r;
    if (i < S) out[(bh * S + i) * Dh + d] = __float2bfloat16(sO[r * ldo + d] / fmaxf(sL[r], 1e-30f));
  }
  for (int r = threadIdx.x; r < kBQ && q0 + r < S; r += kThreads)
    lse[bh * S + q0 + r] = sM[r] + logf(fmaxf(sL[r], 1e-30f));
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

// q (B, H, S, Dh), k/v (B, H, Sk, Dh), out (B, H, S, Dh) bf16; mask (B, Sk)
// uint8 or null; lse (B, H, S) f32 out. Requires Dh <= 256.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                                   void* out, void* lse, int B, int H, int S, int Sk, int Dh,
                                   float scale, void* stream) {
  const size_t bytes = FlashSmem(round_up(Dh, 16)).total;
  if (bytes > kMaxSmem || B > 65535 || H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), static_cast<float*>(lse), H, S,
      Sk, Dh, scale);
  return static_cast<int>(cudaGetLastError());
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
