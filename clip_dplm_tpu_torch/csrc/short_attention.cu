// Packed-qkv short-sequence attention forward with rotate-half RoPE, and the
// out-projection y = o·Wo^T + bo, for Hopper (sm_90a).
//
// Replaces clip_dplm_tpu/ops/short_attention.py::_fwd_kernel_qkv, the body of
// fused_short_attention_qkv_proj (pallas_call in _fwd_call_qkv). The TPU
// kernel runs G batch rows per program with all heads unrolled and the
// out-projection in the same program; here the work is two launches:
//
//   short_attn_qkv_kernel: one block of 8 warps per (query tile of up to 64
//     rows, head, batch row). K and V of the head for the whole sequence
//     (S <= 256) are staged in shared memory with 16-byte loads; RoPE is
//     applied to q and k while staging, in f32, rounded to bf16 (as the TPU
//     kernel does). Scores are f32 with the additive -1e30 key bias, the
//     softmax is exact (no online rescaling: all keys are resident), p is
//     rounded to bf16 for p·V with f32 accumulation, and the row is divided
//     by max(l, 1e-30). o goes to a (B, S, D) bf16 scratch.
//   out_proj_kernel: a 64x64-tile GEMM with f32 accumulation and a bias
//     epilogue, y = o·Wo^T + bo, Wo in (out, in) layout.
//
// Bounds on the H100: at the serving shapes (S = 128, Dh = 64) a block does
// 2·64·128·64·2 = 2.1 MFLOP on 16 KB of K/V and 8 KB of q, far below the
// tensor cores' ratio of ~295 FLOP per byte, so the loads (K/V re-read by
// each query tile, mostly from L2) and the latency of the block's serial
// phases (stage, q·k^T, softmax, p·V) bound it. WMMA 16x16x16 bf16 tiles
// keep the products on the tensor cores; shared-memory rows are padded so
// that fragment loads do not conflict on banks. Fusing the projection into
// the attention launch, and cp.async/TMA with wgmma, are later work.

#include "common.cuh"

using namespace nvcuda;

namespace clip_dplm {
namespace {

constexpr int kThreads = 128;   // the out-projection GEMM: 4 warps
constexpr int kAttnThreads = 256;  // the attention kernel: 8 warps
constexpr int kAttnWarps = kAttnThreads / kWarp;

// Shared-memory layout of one attention block. Row pitches are padded (+8
// bf16, +4 f32) so that the rows of a 16x16 fragment fall on different banks.
struct AttnSmem {
  int ld_kv, ld_s, ld_o, ld_p;
  size_t k, v, q, so, p, l, bias, total;
  __host__ __device__ AttnSmem(int Sp, int Dp, int QT) {
    ld_kv = Dp + 8;
    ld_s = Sp + 4;
    ld_o = Dp + 4;
    ld_p = Sp + 8;
    const int ld_so = ld_s > ld_o ? ld_s : ld_o;
    size_t off = 0;
    k = off;    off += align128(size_t(Sp) * ld_kv * sizeof(bf16));
    v = off;    off += align128(size_t(Sp) * ld_kv * sizeof(bf16));
    q = off;    off += align128(size_t(QT) * ld_kv * sizeof(bf16));
    so = off;   off += align128(size_t(QT) * ld_so * sizeof(float));  // scores, then o
    p = off;    off += align128(size_t(QT) * ld_p * sizeof(bf16));
    l = off;    off += align128(size_t(QT) * sizeof(float));
    bias = off; off += align128(size_t(Sp) * sizeof(float));
    total = off;
  }
};

__global__ void __launch_bounds__(kAttnThreads)
short_attn_qkv_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ mask,
                      const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                      bf16* __restrict__ o, int S, int H, int Dh, float scale, int QT) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = H * Dh, D3 = 3 * D;
  const int Sp = round_up(S, 16), Dp = round_up(Dh, 16);
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const AttnSmem lay(Sp, Dp, QT);
  bf16* sK = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + lay.v);
  bf16* sQ = reinterpret_cast<bf16*>(smem + lay.q);
  float* sS = reinterpret_cast<float*>(smem + lay.so);
  float* sO = sS;  // o reuses the score rows once p is formed
  bf16* sP = reinterpret_cast<bf16*>(smem + lay.p);
  float* sL = reinterpret_cast<float*>(smem + lay.l);
  float* sBias = reinterpret_cast<float*>(smem + lay.bias);
  const int ldkv = lay.ld_kv, lds = lay.ld_s, ldo = lay.ld_o, ldp = lay.ld_p;

  const bf16* base = qkv + size_t(b) * S * D3;
  const uint8_t* mask_row = mask == nullptr ? nullptr : mask + size_t(b) * S;
  stage_rows(sK, ldkv, base + D + h * Dh, D3, Sp, S, Dh, Dp, cos_t, sin_t, 0);
  stage_rows(sV, ldkv, base + 2 * D + h * Dh, D3, Sp, S, Dh, Dp, nullptr, nullptr, 0);
  stage_rows(sQ, ldkv, base + size_t(q0) * D3 + h * Dh, D3, QT, S - q0, Dh, Dp, cos_t, sin_t,
             q0);
  for (int j = threadIdx.x; j < Sp; j += kAttnThreads) sBias[j] = key_bias(mask_row, j, S);
  __syncthreads();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  // scores: (QT x Dp) · (Dp x Sp), f32 accumulation
  {
    const int nC = Sp / 16, tiles = (QT / 16) * nC;
    for (int t = warp; t < tiles; t += kAttnWarps) {
      const int r = t / nC, c = t % nC;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < Dp; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, sQ + r * 16 * ldkv + kk, ldkv);
        wmma::load_matrix_sync(bt, sK + c * 16 * ldkv + kk, ldkv);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(sS + r * 16 * lds + c * 16, acc, lds, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // exact softmax per query row; p stays unnormalized until the end
  for (int r = warp; r < QT; r += kAttnWarps) {
    float* srow = sS + r * lds;
    float m = -INFINITY;
    for (int j = lane; j < Sp; j += kWarp) {
      const float s = srow[j] * scale + sBias[j];
      srow[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < Sp; j += kWarp) {
      const float p = expf(srow[j] - m);
      sP[r * ldp + j] = __float2bfloat16(p);
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) sL[r] = fmaxf(l, 1e-30f);
  }
  __syncthreads();

  // o = p · V: (QT x Sp) · (Sp x Dp), written over the score rows
  {
    const int nC = Dp / 16, tiles = (QT / 16) * nC;
    for (int t = warp; t < tiles; t += kAttnWarps) {
      const int r = t / nC, c = t % nC;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < Sp; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, sP + r * 16 * ldp + kk, ldp);
        wmma::load_matrix_sync(bv, sV + kk * ldkv + c * 16, ldkv);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(sO + r * 16 * ldo + c * 16, acc, ldo, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // o rows in 8-element (16-byte) chunks; Dh % 8 == 0
  const int cpr = Dh / 8;
  for (int idx = threadIdx.x; idx < QT * cpr; idx += kAttnThreads) {
    const int r = idx / cpr, d0 = (idx % cpr) * 8, i = q0 + r;
    if (i >= S) continue;
    const float inv = 1.f / sL[r];
    const float* src = sO + r * ldo + d0;
    uint4 u;
    __nv_bfloat162* u2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) u2[e] = __floats2bfloat162_rn(src[2 * e] * inv, src[2 * e + 1] * inv);
    *reinterpret_cast<uint4*>(o + (size_t(b) * S + i) * D + h * Dh + d0) = u;
  }
}

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kLdAB = kBK + 8;  // bf16 row pitch of the staged tiles
constexpr int kLdC = kBN + 4;   // f32 row pitch of the epilogue tile

// y[m, n] = sum_k x[m, k] * w[n, k] + bias[n]; x (M, K), w (N, K), y (M, N)
// row-major bf16, K and N multiples of 8, pointers 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
out_proj_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const bf16* __restrict__ bias, bf16* __restrict__ y, int M, int N, int K) {
  __shared__ __align__(128) unsigned char smem_a[kBM * kLdAB * sizeof(bf16)];
  __shared__ __align__(128) unsigned char smem_b[kBN * kLdAB * sizeof(bf16)];
  __shared__ __align__(128) float sC[kBM * kLdC];
  bf16* sA = reinterpret_cast<bf16*>(smem_a);
  bf16* sB = reinterpret_cast<bf16*>(smem_b);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / kWarp, wm = warp / 2, wn = warp % 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // 16-byte chunks: 64 rows x 4 chunks per operand tile
    for (int c = threadIdx.x; c < kBM * (kBK / 8); c += kThreads) {
      const int r = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
      const int gk = k0 + kc;
      uint4 va = make_uint4(0, 0, 0, 0), vb = make_uint4(0, 0, 0, 0);
      if (m0 + r < M && gk < K) va = *reinterpret_cast<const uint4*>(x + size_t(m0 + r) * K + gk);
      if (n0 + r < N && gk < K) vb = *reinterpret_cast<const uint4*>(w + size_t(n0 + r) * K + gk);
      *reinterpret_cast<uint4*>(sA + r * kLdAB + kc) = va;
      *reinterpret_cast<uint4*>(sB + r * kLdAB + kc) = vb;
    }
    __syncthreads();
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], sA + (wm * 32 + i * 16) * kLdAB + kk, kLdAB);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bw[j], sB + (wn * 32 + j * 16) * kLdAB + kk, kLdAB);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sC + (wm * 32 + i * 16) * kLdC + wn * 32 + j * 16, acc[i][j], kLdC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kBM * kBN; idx += kThreads) {
    const int r = idx / kBN, c = idx % kBN, gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N)
      y[size_t(gm) * N + gn] = __float2bfloat16(sC[r * kLdC + c] + __bfloat162float(bias[gn]));
  }
}

}  // namespace
}  // namespace clip_dplm

using namespace clip_dplm;

// qkv (B, S, 3D) bf16; mask (B, S) uint8 or null; cos/sin (S, Dh/2) f32 or
// null (no RoPE); o (B, S, D) bf16. Requires Dh % 8 == 0, Dh <= 128, S <= 256.
extern "C" int short_attention_qkv_fwd(const void* qkv, const void* mask, const void* cos_t,
                                       const void* sin_t, void* o, int B, int S, int H, int Dh,
                                       float scale, void* stream) {
  const int Sp = round_up(S, 16), Dp = round_up(Dh, 16);
  int QT = 64;  // query rows per block; fewer when K/V of the head fill shared memory
  while (QT > 16 && AttnSmem(Sp, Dp, QT).total > kMaxSmem) QT /= 2;
  const size_t bytes = AttnSmem(Sp, Dp, QT).total;
  if (bytes > kMaxSmem || B > 65535 || H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(short_attn_qkv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + QT - 1) / QT, H, B);
  short_attn_qkv_kernel<<<grid, kAttnThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), static_cast<bf16*>(o),
      S, H, Dh, scale, QT);
  return static_cast<int>(cudaGetLastError());
}

// x (M, K), w (N, K), bias (N), y (M, N), all bf16.
extern "C" int short_attention_out_proj(const void* x, const void* w, const void* bias, void* y,
                                        int M, int N, int K, void* stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  out_proj_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      static_cast<bf16*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
