// Blockwise online-softmax attention forward with a (B, Sk) key mask, for
// Hopper (sm_90a).
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
// later work.

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
                 bf16* __restrict__ out, int H, int S, int Sk, int Dh, float scale) {
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
}

}  // namespace
}  // namespace clip_dplm

using namespace clip_dplm;

// q (B, H, S, Dh), k/v (B, H, Sk, Dh), out (B, H, S, Dh) bf16; mask (B, Sk)
// uint8 or null. Requires Dh <= 256.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                                   void* out, int B, int H, int S, int Sk, int Dh, float scale,
                                   void* stream) {
  const size_t bytes = FlashSmem(round_up(Dh, 16)).total;
  if (bytes > kMaxSmem || B > 65535 || H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), H, S, Sk, Dh, scale);
  return static_cast<int>(cudaGetLastError());
}
