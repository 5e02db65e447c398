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
//   dense_gemm_kernel (csrc/dense_gemm.cuh, shared with the fused Dense
//     block): y = bf16(o·Wo^T + bo) with f32 accumulation, Wo in (out, in)
//     layout, the bias added before the one rounding.
//
// Bounds on the H100: at the serving shapes (S = 128, Dh = 64) a block does
// 2·64·128·64·2 = 2.1 MFLOP on 16 KB of K/V and 8 KB of q, far below the
// tensor cores' ratio of ~295 FLOP per byte, so the loads (K/V re-read by
// each query tile, mostly from L2) and the latency of the block's serial
// phases (stage, q·k^T, softmax, p·V) bound it. WMMA 16x16x16 bf16 tiles
// keep the products on the tensor cores; shared-memory rows are padded so
// that fragment loads do not conflict on banks. Fusing the projection into
// the attention launch, and cp.async/TMA with wgmma, are later work.
//
// Backward: short_attn_qkv_bwd_kernel replaces _bwd_kernel_qkv (pallas_call in
// _bwd_call_qkv), recompute mode. The out-projection's part of the TPU
// kernel (dO = dy·Wo^T) is the shared GEMM, launched by the wrapper; dWo and
// dbo are plain matmuls there, as the JAX package leaves them to XLA. One
// block of 16 warps per (head, batch row) holds K and V of the head for the
// whole sequence and f32 dK/dV accumulators in shared memory, and walks the
// query rows in tiles of up to 64: no atomics and no second pass. Per tile it
// recomputes the scores as the forward does (RoPE'd q/k rounded to bf16, f32
// scores · scale + key bias, max, exp, l = max(Σp, 1e-30)), then prob = p/l
// (f32), dP = dO·V^T, delta = rowsum(dO∘o) from the saved o, ds =
// bf16(prob·(dP − delta)·scale), dQ = ds·K, dK += ds^T·Q, dV += bf16(prob)^T·dO:
// the TPU kernel's rounding points. dQ and dK leave through the inverse
// rotation in f32. At the flagship shape (S = 128, Dh = 64) a block moves
// ~100 KB and does ~10 MFLOP on WMMA tiles, under the tensor cores' ~295
// FLOP/B, so memory bounds the kernel on paper (qkv, o, dO in, dqkv out);
// in practice the one-block-per-SM occupancy that its 223 KB of shared
// memory forces (QT = 64), and the block's serial phases, bound it.

#include "dense_gemm.cuh"

using namespace nvcuda;

namespace clip_dplm {
namespace {

constexpr int kAttnThreads = 256;  // the attention kernel: 8 warps
constexpr int kAttnWarps = kAttnThreads / kWarp;
// the backward kernel: 16 warps, so that the one block per SM that its
// shared memory allows hides more of the latency of its serial phases
// (PERF.md, the findings of slice 3)
constexpr int kBwdThreads = 512;
constexpr int kBwdWarps = kBwdThreads / kWarp;

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

// Shared-memory layout of one backward block. Python mirrors it in
// ops/short_attention.py::_bwd_smem_bytes to refuse, before the forward, a
// shape whose backward does not fit.
struct BwdSmem {
  int ld_kv, ld_acc, ld_s, ld_p;
  size_t k, v, q, dout, dk, dv, s, dp, pb, ds, bias, delta, total;
  __host__ __device__ BwdSmem(int Sp, int Dp, int QT) {
    ld_kv = Dp + 8;
    ld_acc = Dp + 4;
    ld_s = Sp + 4;
    ld_p = Sp + 8;
    const int ld_sq = ld_s > ld_acc ? ld_s : ld_acc;
    size_t off = 0;
    k = off;     off += align128(size_t(Sp) * ld_kv * sizeof(bf16));
    v = off;     off += align128(size_t(Sp) * ld_kv * sizeof(bf16));
    q = off;     off += align128(size_t(QT) * ld_kv * sizeof(bf16));
    dout = off;  off += align128(size_t(QT) * ld_kv * sizeof(bf16));
    dk = off;    off += align128(size_t(Sp) * ld_acc * sizeof(float));
    dv = off;    off += align128(size_t(Sp) * ld_acc * sizeof(float));
    s = off;     off += align128(size_t(QT) * ld_sq * sizeof(float));  // scores, then dQ
    dp = off;    off += align128(size_t(QT) * ld_s * sizeof(float));
    pb = off;    off += align128(size_t(QT) * ld_p * sizeof(bf16));
    ds = off;    off += align128(size_t(QT) * ld_p * sizeof(bf16));
    bias = off;  off += align128(size_t(Sp) * sizeof(float));
    delta = off; off += align128(size_t(QT) * sizeof(float));
    total = off;
  }
};

// Rows [0, n_rows) of an f32 gradient tile (row pitch ld) to bf16 rows of
// dst (row pitch row_stride), in 8-element chunks (Dh % 8 == 0). With cos/sin
// (position pos0 + r) the rows pass through the inverse rotate-half RoPE
// first: [g1·cos + g2·sin, g2·cos − g1·sin], in f32.
__device__ inline void write_grad_rows(bf16* dst, size_t row_stride, const float* src, int ld,
                                       int n_rows, int Dh, const float* cos_t,
                                       const float* sin_t, int pos0) {
  const int half = Dh / 2, cpr = Dh / 8;
  for (int idx = threadIdx.x; idx < n_rows * cpr; idx += blockDim.x) {
    const int r = idx / cpr, d0 = (idx % cpr) * 8;
    const float* g = src + r * ld;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int d = d0 + e;
      if (cos_t == nullptr) {
        v[e] = g[d];
      } else {
        const size_t p = size_t(pos0 + r) * half;
        const int i = d < half ? d : d - half;
        v[e] = d < half ? g[d] * cos_t[p + i] + g[d + half] * sin_t[p + i]
                        : g[d] * cos_t[p + i] - g[i] * sin_t[p + i];
      }
    }
    store8(dst + r * row_stride + d0, v);
  }
}

__global__ void __launch_bounds__(kBwdThreads)
short_attn_qkv_bwd_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ mask,
                          const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                          const bf16* __restrict__ o, const bf16* __restrict__ dout,
                          bf16* __restrict__ dqkv, int S, int H, int Dh, float scale, int QT) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = H * Dh, D3 = 3 * D;
  const int Sp = round_up(S, 16), Dp = round_up(Dh, 16);
  const int h = blockIdx.x, b = blockIdx.y;
  const BwdSmem lay(Sp, Dp, QT);
  bf16* sK = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + lay.v);
  bf16* sQ = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* sDO = reinterpret_cast<bf16*>(smem + lay.dout);
  float* sDK = reinterpret_cast<float*>(smem + lay.dk);
  float* sDV = reinterpret_cast<float*>(smem + lay.dv);
  float* sS = reinterpret_cast<float*>(smem + lay.s);
  float* sDQ = sS;  // the dQ tile reuses the score rows once ds is formed
  float* sDP = reinterpret_cast<float*>(smem + lay.dp);
  bf16* sPB = reinterpret_cast<bf16*>(smem + lay.pb);
  bf16* sDS = reinterpret_cast<bf16*>(smem + lay.ds);
  float* sBias = reinterpret_cast<float*>(smem + lay.bias);
  float* sDelta = reinterpret_cast<float*>(smem + lay.delta);
  const int ldkv = lay.ld_kv, ldacc = lay.ld_acc, lds = lay.ld_s, ldp = lay.ld_p;

  const bf16* base = qkv + size_t(b) * S * D3;
  const bf16* o_base = o + size_t(b) * S * D + h * Dh;
  const bf16* do_base = dout + size_t(b) * S * D + h * Dh;
  bf16* g_base = dqkv + size_t(b) * S * D3;
  const uint8_t* mask_row = mask == nullptr ? nullptr : mask + size_t(b) * S;
  stage_rows(sK, ldkv, base + D + h * Dh, D3, Sp, S, Dh, Dp, cos_t, sin_t, 0);
  stage_rows(sV, ldkv, base + 2 * D + h * Dh, D3, Sp, S, Dh, Dp, nullptr, nullptr, 0);
  for (int j = threadIdx.x; j < Sp; j += kBwdThreads) sBias[j] = key_bias(mask_row, j, S);
  for (int i = threadIdx.x; i < Sp * ldacc; i += kBwdThreads) sDK[i] = sDV[i] = 0.f;

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int q0 = 0; q0 < S; q0 += QT) {
    __syncthreads();  // the previous tile is done with sQ, sDO and the dQ rows
    stage_rows(sQ, ldkv, base + size_t(q0) * D3 + h * Dh, D3, QT, S - q0, Dh, Dp, cos_t, sin_t,
               q0);
    stage_rows(sDO, ldkv, do_base + size_t(q0) * D, D, QT, S - q0, Dh, Dp, nullptr, nullptr, 0);
    __syncthreads();

    // delta = rowsum(dO∘o) in f32; padding rows have dO = 0
    for (int r = warp; r < QT; r += kBwdWarps) {
      float acc = 0.f;
      if (q0 + r < S)
        for (int d = lane; d < Dh; d += kWarp)
          acc += __bfloat162float(sDO[r * ldkv + d]) *
                 __bfloat162float(o_base[size_t(q0 + r) * D + d]);
      acc = warp_sum(acc);
      if (lane == 0) sDelta[r] = acc;
    }
    // scores = Q·K^T and dP = dO·V^T, (QT x Dp)·(Dp x Sp) each, f32 accumulation
    {
      const int nC = Sp / 16, tiles = (QT / 16) * nC;
      for (int t = warp; t < 2 * tiles; t += kBwdWarps) {
        const bool is_dp = t >= tiles;
        const int r = (t % tiles) / nC, c = (t % tiles) % nC;
        const bf16* A = is_dp ? sDO : sQ;
        const bf16* Bt = is_dp ? sV : sK;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        for (int kk = 0; kk < Dp; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
          wmma::load_matrix_sync(a, A + r * 16 * ldkv + kk, ldkv);
          wmma::load_matrix_sync(bt, Bt + c * 16 * ldkv + kk, ldkv);
          wmma::mma_sync(acc, a, bt, acc);
        }
        wmma::store_matrix_sync((is_dp ? sDP : sS) + r * 16 * lds + c * 16, acc, lds,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();

    // the forward's softmax, bit for bit; then prob = p / l, ds
    for (int r = warp; r < QT; r += kBwdWarps) {
      float* srow = sS + r * lds;
      const float* dprow = sDP + r * lds;
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
        srow[j] = p;
        l += p;
      }
      l = fmaxf(warp_sum(l), 1e-30f);
      const float delta = sDelta[r];
      for (int j = lane; j < Sp; j += kWarp) {
        const float prob = srow[j] / l;
        sPB[r * ldp + j] = __float2bfloat16(prob);
        sDS[r * ldp + j] = __float2bfloat16(prob * (dprow[j] - delta) * scale);
      }
    }
    __syncthreads();

    // dQ = ds·K (QT x Dp, into the score rows); dK += ds^T·Q; dV += bf16(prob)^T·dO
    {
      const int nC = Dp / 16, tq = (QT / 16) * nC, tk = (Sp / 16) * nC;
      for (int t = warp; t < tq + 2 * tk; t += kBwdWarps) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        if (t < tq) {
          const int r = t / nC, c = t % nC;
          wmma::fill_fragment(acc, 0.f);
          for (int kk = 0; kk < Sp; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bk;
            wmma::load_matrix_sync(a, sDS + r * 16 * ldp + kk, ldp);
            wmma::load_matrix_sync(bk, sK + kk * ldkv + c * 16, ldkv);
            wmma::mma_sync(acc, a, bk, acc);
          }
          wmma::store_matrix_sync(sDQ + r * 16 * ldacc + c * 16, acc, ldacc,
                                  wmma::mem_row_major);
        } else {
          const bool is_dv = t - tq >= tk;
          const int u = (t - tq) % tk, r = u / nC, c = u % nC;  // r: key tile
          float* acc_p = (is_dv ? sDV : sDK) + r * 16 * ldacc + c * 16;
          const bf16* P = is_dv ? sPB : sDS;
          const bf16* X = is_dv ? sDO : sQ;
          wmma::load_matrix_sync(acc, acc_p, ldacc, wmma::mem_row_major);
          for (int kk = 0; kk < QT; kk += 16) {
            // A = P^T: element (key i, query j) is P[j][i], column-major with pitch ldp
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bx;
            wmma::load_matrix_sync(a, P + kk * ldp + r * 16, ldp);
            wmma::load_matrix_sync(bx, X + kk * ldkv + c * 16, ldkv);
            wmma::mma_sync(acc, a, bx, acc);
          }
          wmma::store_matrix_sync(acc_p, acc, ldacc, wmma::mem_row_major);
        }
      }
    }
    __syncthreads();
    const int rows = S - q0 < QT ? S - q0 : QT;
    write_grad_rows(g_base + size_t(q0) * D3 + h * Dh, D3, sDQ, ldacc, rows, Dh, cos_t, sin_t,
                    q0);
  }
  __syncthreads();
  write_grad_rows(g_base + D + h * Dh, D3, sDK, ldacc, S, Dh, cos_t, sin_t, 0);
  write_grad_rows(g_base + 2 * D + h * Dh, D3, sDV, ldacc, S, Dh, nullptr, nullptr, 0);
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

// Backward of short_attention_qkv_fwd from its residuals: qkv, mask, cos/sin
// as there; o (B, S, D) bf16 the forward's output; dout (B, S, D) bf16 its
// cotangent; dqkv (B, S, 3D) bf16 out. Query tile of 64 rows, fewer when
// shared memory is short; a shape that does not fit at 16 is refused.
extern "C" int short_attention_qkv_bwd(const void* qkv, const void* mask, const void* cos_t,
                                       const void* sin_t, const void* o, const void* dout,
                                       void* dqkv, int B, int S, int H, int Dh, float scale,
                                       void* stream) {
  const int Sp = round_up(S, 16), Dp = round_up(Dh, 16);
  int QT = Sp < 64 ? Sp : 64;
  while (QT > 16 && BwdSmem(Sp, Dp, QT).total > kMaxSmem) QT /= 2;
  const size_t bytes = BwdSmem(Sp, Dp, QT).total;
  if (bytes > kMaxSmem || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(short_attn_qkv_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H, B);
  short_attn_qkv_bwd_kernel<<<grid, kBwdThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<bf16*>(dqkv), S,
      H, Dh, scale, QT);
  return static_cast<int>(cudaGetLastError());
}

// x (M, K), w (N, K), bias (N), y (M, N), all bf16.
extern "C" int short_attention_out_proj(const void* x, const void* w, const void* bias, void* y,
                                        int M, int N, int K, void* stream) {
  return static_cast<int>(launch_dense_gemm<false>(x, w, bias, y, M, N, K, false,
                                                   static_cast<cudaStream_t>(stream)));
}
